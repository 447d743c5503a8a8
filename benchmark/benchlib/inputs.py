"""Inputs made from the seed: image pairs with changed regions, and the
random streams a run draws from. The same seed gives the same inputs."""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for one named stream of a run's seed."""
    return np.random.default_rng([seed & ((1 << 64) - 1), sum(map(ord, stream)), len(stream)])


def image_pairs(seed: int, count: int, size: int):
    """(pre, post, change): ``count`` uint8 [size, size, 3] pairs of blocky
    texture with noise, where post differs from pre in a few rectangles
    (``change`` [count, size, size] uint8 in {0, 1})."""
    r = rng(seed, "pairs")
    cell = 8

    def texture(n):
        base = r.integers(0, 256, (n, size // cell, size // cell, 3), dtype=np.uint8)
        img = np.repeat(np.repeat(base, cell, axis=1), cell, axis=2).astype(np.int16)
        img += r.integers(-24, 25, img.shape, dtype=np.int16)
        return np.clip(img, 0, 255).astype(np.uint8)

    pre, other = texture(count), texture(count)
    post, change = pre.copy(), np.zeros((count, size, size), np.uint8)
    for i in range(count):
        for _ in range(int(r.integers(1, 5))):
            h, w = (int(v) for v in r.integers(size // 16, size // 3, 2))
            y, x = int(r.integers(0, size - h)), int(r.integers(0, size - w))
            post[i, y:y + h, x:x + w] = other[i, y:y + h, x:x + w]
            change[i, y:y + h, x:x + w] = 1
    return pre, post, change
