"""Sliding-window tiling for full-scene inference, numpy only (a copy of
``change3d_tpu/utils/tiling.py``).

The model runs at a fixed patch size (its perception frames are sized
[1, N, in_height, in_width, 3]), so a scene larger than that is cut into
model-sized windows and the per-window maps are blended back. Every device
shape stays fixed: one batch shape serves every tile of every scene.
"""

from __future__ import annotations

import numpy as np


def window_starts(full: int, size: int, stride: int) -> list:
    """Start offsets covering [0, full) with a final edge-anchored window
    (no padding needed when ``full >= size``)."""
    if full < size:
        return []
    starts = list(range(0, full - size + 1, stride))
    if starts[-1] != full - size:
        starts.append(full - size)
    return starts


def blend_window(size_h: int, size_w: int, overlap: int, floor: float = 0.05) -> np.ndarray:
    """[size_h, size_w] blending weights: 1.0 in the interior, a cosine taper
    to ``floor`` within ``overlap`` px of each edge.

    ``floor`` > 0 so pixels covered by a single tile (scene borders) still
    reconstruct exactly after the weighted-sum/weight division; interior
    seams are dominated by whichever tile sees the pixel farthest from its
    own border.
    """
    if overlap <= 0:
        return np.ones((size_h, size_w), np.float32)

    def ramp(size):
        w = np.ones(size, np.float32)
        n = min(overlap, size // 2)
        t = (1 - np.cos(np.linspace(0, np.pi, n, endpoint=False))) / 2  # 0 -> ~1
        edge = floor + (1 - floor) * t
        w[:n] = edge
        w[size - n:] = edge[::-1]
        return w

    return np.outer(ramp(size_h), ramp(size_w)).astype(np.float32)


def pad_scene(scene: np.ndarray, tile_h: int, tile_w: int) -> np.ndarray:
    """Edge-pad a scene up to at least one tile in each dimension."""
    pad_h = max(0, tile_h - scene.shape[0])
    pad_w = max(0, tile_w - scene.shape[1])
    if pad_h or pad_w:
        scene = np.pad(scene, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
    return scene


def scene_offsets(h: int, w: int, tile_h: int, tile_w: int, overlap: int):
    """All (y, x) window origins covering an [h, w] scene."""
    stride_h = max(1, tile_h - overlap)
    stride_w = max(1, tile_w - overlap)
    return [
        (y, x)
        for y in window_starts(h, tile_h, stride_h)
        for x in window_starts(w, tile_w, stride_w)
    ]


def tile_scene(scene: np.ndarray, tile_h: int, tile_w: int, overlap: int):
    """Slice [H, W, C] into model-sized tiles.

    Returns (tiles [N, tile_h, tile_w, C], offsets [(y, x)] * N). Scenes
    smaller than the tile in either dimension are edge-padded up front (the
    pad is cropped away again by ``untile_scene``'s canvas shape).
    """
    scene = pad_scene(scene, tile_h, tile_w)
    offsets = scene_offsets(scene.shape[0], scene.shape[1], tile_h, tile_w, overlap)
    tiles = np.stack([scene[y : y + tile_h, x : x + tile_w] for y, x in offsets])
    return tiles, offsets


def untile_scene(
    tiles: np.ndarray, offsets, out_h: int, out_w: int, overlap: int
) -> np.ndarray:
    """Blend per-tile maps [N, th, tw, C] back onto an [out_h, out_w, C]
    canvas with cosine-tapered weighted averaging over overlaps."""
    n, th, tw, c = tiles.shape
    canvas_h = max(out_h, th)
    canvas_w = max(out_w, tw)
    acc = np.zeros((canvas_h, canvas_w, c), np.float32)
    wacc = np.zeros((canvas_h, canvas_w, 1), np.float32)
    w = blend_window(th, tw, overlap)[..., None]
    for (y, x), t in zip(offsets, tiles):
        acc[y : y + th, x : x + tw] += t.astype(np.float32) * w
        wacc[y : y + th, x : x + tw] += w
    return (acc / wacc)[:out_h, :out_w]
