"""Weight bridge from the JAX package's variables to this port's state_dict.

``from_jax_variables`` takes the ``{'params', 'batch_stats'}`` tree of a
``change3d_tpu`` Change3D (or bare X3D) as numpy arrays and returns the
state_dict of the matching port module. It un-stacks the scan layout
(``stageK/pairs/{a,b}`` carry a leading axis: a[p] is block 2p+1, b[p] block
2p+2; a trailing odd block stays ``block{depth-1}``) and transposes conv
kernels to the port's layouts:

  conv3d  DHWIO (kt,kh,kw,I,O)  -> (O, I, kt, kh, kw)
  conv2d  HWIO  (kh,kw,I,O)     -> (O, I, kh, kw)
  up      (kh,kw,I,O)           -> (I, O, kh, kw)  (ConvTranspose, not flipped)
  block-0 projection (1,1,1,I,O) -> [I, O]
  pointwise / SE / FC [I, O]    -> unchanged
  caption decoder (``decoder/...``: embedding, attention and output
  matrices [in, out], LayerNorm scale/bias) -> unchanged

Detection trees come without ``stage4`` (flax never materialises it there);
a CC tree has stage4 for CC and the caption decoder. The classifier head is
not ported and is dropped.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from change3d_tpu_torch.models.x3d import X3DConfig, x3d_l_config

def _walk(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _unstack_pairs(path, value):
    """Yield (path, value) with ``stageK/pairs/{a,b}/...`` split into
    ``stageK/block{j}/...``."""
    if "pairs" not in path:
        yield path, value
        return
    i = path.index("pairs")
    first = 1 if path[i + 1] == "a" else 2
    for p in range(value.shape[0]):
        yield path[:i] + (f"block{2 * p + first}",) + path[i + 2:], value[p]


def _convert_leaf(path, v: np.ndarray) -> np.ndarray:
    name = path[-1]
    if name in ("conv_s", "conv_t", "conv_b"):          # DHWIO
        return v.transpose(4, 3, 0, 1, 2)
    if name == "proj":                                   # strided 1x1x1
        return v[0, 0, 0]
    if name in ("reduce", "final"):                      # HWIO
        return v.transpose(3, 2, 0, 1)
    if name == "up":                                     # (kh,kw,I,O)
        return v.transpose(2, 3, 0, 1)
    return v


def from_jax_variables(variables: Mapping, cfg: Optional[X3DConfig] = None) -> Dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` (numpy leaves) -> port state_dict.

    Raises if a stage present in the tree does not hold exactly
    ``cfg.stage_depths`` blocks."""
    cfg = cfg or x3d_l_config()
    out: Dict[str, torch.Tensor] = {}
    blocks: Dict[str, set] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _walk(variables.get(collection, {})):
            if "head" in path:
                continue
            for p, v in _unstack_pairs(path, value):
                key = ".".join(p)
                if key in out:
                    raise ValueError(f"duplicate key {key}")
                out[key] = torch.from_numpy(np.array(_convert_leaf(p, v), order="C"))
                stage = next((s for s in p if s.startswith("stage")), None)
                if stage is not None:
                    blocks.setdefault(stage, set()).add(p[p.index(stage) + 1])
    for stage, found in blocks.items():
        want = {f"block{j}" for j in range(cfg.stage_depths[int(stage[5:]) - 1])}
        if found != want:
            raise ValueError(f"{stage}: blocks {sorted(found)} do not match depth {len(want)}")
    return out
