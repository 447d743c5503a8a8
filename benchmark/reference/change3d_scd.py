"""Plain fp32 reference of Change3D's semantic change detection (SCD).

Written from the published description (Change3D, CVPR 2025,
``model/trainer.py`` and ``scripts/train_SCD.py``): the pair and three
learned perception frames as a five-frame clip through X3D-L stages 1-3,
the pair's difference added to the middle frame after the stem and after
each stage, and three FPN change decoders, one on each perception frame's
taps: ``decoder_pre`` (the pre image's classes) on the first,
``decoder_change`` (binary, before its sigmoid) on the second, the middle
frame that carries the difference, and ``decoder_post`` on the third. It
reuses the BCD reference (``change3d.py``: the clip, stem, X3D blocks, BN
and products) and imports nothing of the program and nothing of JAX.

Departures from the published description, all shared with ``change3d.py``:
eval BN from running statistics as one scale and shift; activations in
PyTorch's channel-first layout; the semantic maps are the heads' raw
logits, not gated by the change mask (a deployment gates them on the host,
``train_SCD.py``'s eval multiplies them by the change decision).

Parameters are one flat dict under the program's ``state_dict`` names
(``param_spec``). ``quant="fp8"`` rounds both operands of every product to
float8 e4m3 (``change3d.Ops``): the lower-precision control of the bf16
cell. Building a reference turns TF32 off, so fp32 products run in fp32
on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from benchmark.reference import change3d
from benchmark.reference.change3d import Change3DRef, Params

# (head, classes): the program's attribute names and each head's outputs
# (None: the configuration's ``num_classes``). The frame each head reads is
# its index here: pre on the first perception frame, change on the second.
HEADS = (("decoder_pre", None), ("decoder_change", 1), ("decoder_post", None))


def _head_cfg(cfg: dict, classes: Optional[int]) -> dict:
    """``cfg`` as the BCD reference's configuration of one head."""
    return dict(cfg, task="bcd", num_classes=classes or cfg["num_classes"])


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, rule) of every parameter and BN statistic (rules as in
    ``change3d.param_spec``): the encoder's, then each head's FPN decoder
    under its own name."""
    spec = [e for e in change3d.param_spec(_head_cfg(cfg, None))
            if not e[0].startswith("decoder.")]
    for head, classes in HEADS:
        spec += [(head + name[len("decoder"):], shape, rule)
                 for name, shape, rule in change3d.param_spec(_head_cfg(cfg, classes))
                 if name.startswith("decoder.")]
    return spec


def make_params(cfg: dict, seed: int, device) -> Params:
    """Every parameter from ``seed`` by ``change3d.make_params``' rules: the
    encoder and ``decoder_pre`` from ``seed``'s draw, each further head from
    the draw of the next seed (whose encoder is left unused)."""
    params: Params = {}
    for i, (head, classes) in enumerate(HEADS):
        drawn = change3d.make_params(_head_cfg(cfg, classes), seed + i, device)
        for name, value in drawn.items():
            if name.startswith("decoder."):
                params[head + name[len("decoder"):]] = value
            elif i == 0:
                params[name] = value
    return params


class ScdRef(Change3DRef):
    """The SCD eval forward over a params dict."""

    def __init__(self, cfg: dict, params: Params, *, quant: Optional[str] = None):
        change3d.no_tf32()
        super().__init__(cfg, params, quant=quant)

    def frame_taps(self, pre, post) -> List[List[torch.Tensor]]:
        """Per perception frame, its features after the stem and stages 1-3,
        the middle frame enhanced by the pair's difference at each."""
        x, n = self.clip(pre, post), self.cfg["perception_frames"]
        taps: List[List[torch.Tensor]] = [[] for _ in range(n)]
        for i in range(4):
            x = self.stem(x) if i == 0 else self.stage(x, i - 1)
            diff = (x[:, :, 0] - x[:, :, n + 1]).abs()
            enh = torch.relu(self.ops.pointwise(diff[:, :, None], self.p[f"encoder.fc{i}.conv"]))
            mid = x.shape[2] // 2
            x = torch.cat([x[:, :, :mid], x[:, :, mid:mid + 1] + enh, x[:, :, mid + 1:]], dim=2)
            for k in range(n):
                taps[k].append(x[:, :, k + 1])
        return taps

    def decode(self, taps: List[torch.Tensor], head: str) -> torch.Tensor:
        """One FPN change decoder's logits [B, C, H, W] over one frame's
        four taps."""
        p, o = self.p, self.ops
        c1, c2, c3, c4 = taps

        def up(x, name):
            x = o.conv2d(x, p[f"{head}.{name}.reduce"])
            return o.conv_transpose2d(x, p[f"{head}.{name}.up"], p[f"{head}.{name}.up_bias"])

        c3 = c3 + up(c4, "up_c4")
        c2 = c2 + up(c3, "up_c3")
        c1 = c1 + up(c2, "up_c2")
        return o.conv2d(c1, p[f"{head}.final"], padding=1)

    def head_logits(self, pre, post) -> Dict[str, torch.Tensor]:
        """Normalised [B, H, W, 3] images -> 'pre' and 'post' class logits
        [B, H, W, num_classes] and 'change' logits [B, H, W] (before the
        sigmoid)."""
        taps = self.frame_taps(pre, post)
        z = {head: self.decode(taps[k], head) for k, (head, _) in enumerate(HEADS)}
        return {"pre": z["decoder_pre"].permute(0, 2, 3, 1),
                "post": z["decoder_post"].permute(0, 2, 3, 1),
                "change": z["decoder_change"][:, 0]}
