"""The numbers that decide ``correct``: what the timed path produced against
the plain fp32 reference, each number held to its own limit (from
``limits/<cell>.json``)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.benchlib.runner import Check
from benchmark.reference.change3d import Change3DRef, no_tf32, normalize_u8


def reference_in_blocks(fn, n: int, block: int = 8) -> np.ndarray:
    """fn(slice) for consecutive slices of range(n), concatenated on the host."""
    outs = []
    for i in range(0, n, block):
        with torch.no_grad():
            outs.append(fn(slice(i, min(n, i + block))).float().cpu().numpy())
    return np.concatenate(outs)


def reference_change_logits(cfg: dict, params, pre: np.ndarray, post: np.ndarray,
                            device) -> np.ndarray:
    """The fp32 reference's change logits [N, H, W] of uint8 pairs."""
    no_tf32()
    ref = Change3DRef(cfg, params)
    pre, post = torch.from_numpy(pre).to(device), torch.from_numpy(post).to(device)
    return reference_in_blocks(lambda s: ref.change_logits(
        normalize_u8(pre[s], cfg["task"]), normalize_u8(post[s], cfg["task"])), len(pre))


def mask_checks(answers: Iterable[Tuple[Sequence[int], np.ndarray]], ref_logits: np.ndarray,
                limits: Dict[str, float], missing: int = 0) -> List[Check]:
    """Served binary masks against the reference's decisions (logit > 0).
    ``answers``: (pair ids, bool masks [n, H, W]) per answer. Numbers: the
    widest reference logit on the wrong side of a served pixel
    (``mask_gap_logit``; a mask of the wrong shape reads inf) and the
    answers that never came."""
    gap = 0.0
    for ids, masks in answers:
        z = ref_logits[np.asarray(ids)]
        if masks.shape != z.shape:
            gap = float("inf")
            continue
        dis = masks.astype(bool) != (z > 0)
        if dis.any():
            gap = max(gap, float(np.abs(z[dis]).max()))
    return [Check("mask_gap_logit", gap, limits["mask_gap_logit"]),
            Check("answers_missing", float(missing), 0.0)]


def token_gaps(ref_logits: torch.Tensor, served: torch.Tensor, lengths: torch.Tensor
               ) -> torch.Tensor:
    """Per row, the widest gap by which a served token's reference logit
    lies below the reference's best at its position. ref_logits [B, L, V]
    score position t + 1 from position t; served [B, L] starts with
    <start>; lengths [B] count the served tokens after <start>."""
    best = ref_logits.max(-1).values[:, :-1]
    picked = torch.gather(ref_logits[:, :-1], -1, served[:, 1:, None])[..., 0]
    pos = torch.arange(served.shape[1] - 1, device=served.device)[None]
    gap = torch.where(pos < lengths[:, None], best - picked, torch.zeros_like(best))
    return gap.max(-1).values


def token_scores(logits: torch.Tensor, served: torch.Tensor, lengths: torch.Tensor
                 ) -> torch.Tensor:
    """Per row, the summed log-probability of the served tokens after
    <start> under ``logits`` (scored as ``token_gaps`` reads them): the
    score a greedy search reports for its caption."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    picked = torch.gather(logp, -1, served[:, 1:, None])[..., 0]
    pos = torch.arange(served.shape[1] - 1, device=served.device)[None]
    return torch.where(pos < lengths[:, None], picked, torch.zeros_like(picked)).sum(-1)
