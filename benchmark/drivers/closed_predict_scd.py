"""Closed loop of semantic change detection: ``Predictor.predict_u8`` on the
SCD model called back to back on batches of uint8 pairs held on the host,
each batch drawn at set-up from a seeded pool of pairs (traffic keys:
``batch``, ``pool``, ``batches``). Reports ``infer_samples_per_s``: pairs
completed over the whole window. Every answer of the window is kept and
checked against the fp32 SCD reference (``reference/change3d_scd.py``) on
its pairs: the change mask as the BCD cell checks it (``mask_gap_logit``),
the pre and post class maps by ``class_gap_logit``, and answers that lack a
map (``answers_missing``).

Variant (the control, never run by the benchmark itself): ``fp8`` the
reference with float8 products in the program's place."""

from __future__ import annotations

import time
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from benchmark.benchlib import compare, inputs, program
from benchmark.benchlib.runner import Check, Window
from benchmark.reference.change3d import normalize_u8
from benchmark.reference.change3d_scd import ScdRef, make_params
from benchmark.work import flops
from benchmark.work.scd import scd_flops

MAPS = ("pre", "post", "change")


class Fp8ScdPredictor:
    """``Predictor.predict_u8`` computed by the SCD reference with float8
    products: uint8 class maps and bool change masks."""

    def __init__(self, cfg, params, device):
        self.ref, self.device = ScdRef(cfg, params, quant="fp8"), device

    @torch.no_grad()
    def predict_u8(self, pre, post):
        put = lambda a: normalize_u8(torch.from_numpy(a).to(self.device), "scd")
        z = self.ref.head_logits(put(pre), put(post))
        out = {k: z[k].argmax(-1).to(torch.uint8) for k in ("pre", "post")}
        out["change"] = z["change"] > 0
        return {k: v.cpu().numpy() for k, v in out.items()}


def reference_logits(cfg: dict, params, pre: np.ndarray, post: np.ndarray, device,
                     block: int = 8) -> Dict[str, torch.Tensor]:
    """The fp32 reference's head logits of uint8 pairs, on ``device``: 'pre'
    and 'post' [N, H, W, C], 'change' [N, H, W]."""
    ref = ScdRef(cfg, params)
    pre, post = torch.from_numpy(pre).to(device), torch.from_numpy(post).to(device)
    outs = []
    with torch.no_grad():
        for i in range(0, len(pre), block):
            s = slice(i, i + block)
            outs.append(ref.head_logits(normalize_u8(pre[s], "scd"), normalize_u8(post[s], "scd")))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def class_gap(answers: Iterable[Tuple[Sequence[int], np.ndarray]], ref: torch.Tensor) -> float:
    """Served class maps against the reference's logits [N, H, W, C]: the
    widest gap, over every served pixel, between the reference's best logit
    and its logit at the served class (0 where they agree; inf for a map of
    the wrong shape or a class out of range). ``answers``: (pair ids, uint8
    class maps [n, H, W]) per answer."""
    best, gap = ref.max(-1).values, 0.0
    for ids, served in answers:
        idx = torch.as_tensor(np.asarray(ids), device=ref.device)
        z = ref[idx]
        served = torch.from_numpy(np.asarray(served)).to(ref.device).long()
        if served.shape != z.shape[:-1] or served.min() < 0 or served.max() >= z.shape[-1]:
            return float("inf")
        picked = torch.gather(z, -1, served[..., None])[..., 0]
        gap = max(gap, float((best[idx] - picked).max()))
    return gap


class Driver:
    def __init__(self, cell, seed: int, device: str, variant=None):
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.limits, self.device = cfg, cell.limits, device
        self.batch = tr["batch"]
        self.params = make_params(cfg, seed, device)
        self.pre, self.post, _ = inputs.image_pairs(seed, tr["pool"], cfg["image_size"])
        draw = inputs.rng(seed, "batches")
        self.ids = [np.sort(draw.choice(tr["pool"], self.batch, replace=False))
                    for _ in range(tr["batches"])]
        self.batches = [(self.pre[i], self.post[i]) for i in self.ids]
        from change3d_tpu_torch.inference import Predictor

        if variant == "fp8":
            self.predictor = Fp8ScdPredictor(cfg, self.params, device)
        else:
            model = program.build_model(cfg, self.params, device)
            self.predictor = Predictor(model, compute_dtype=getattr(torch, cfg["inference_dtype"]),
                                       device=device)
        for pre, post in self.batches[:2]:
            self.predictor.predict_u8(pre, post)
        self.answers = []

    def window(self, seconds: float, tracer) -> Window:
        sync = torch.cuda.synchronize if self.device == "cuda" else None
        predict = self.predictor.predict_u8
        n, t0 = 0, time.perf_counter()
        while True:
            k = n % len(self.batches)
            # A copy of each map, as a caller that consumes the answer and lets
            # it go: the class maps are views of the predictor's pinned host
            # buffers, which the kept answers would otherwise hold for the
            # whole window, so that every call pinned fresh host memory.
            out = predict(*self.batches[k])
            self.answers.append((self.ids[k], {key: v.copy() for key, v in out.items()}))
            n += 1
            now = time.perf_counter()
            tracer.tick(now, t0, n * self.batch, sync)
            if now - t0 >= seconds:
                break
        elapsed = now - t0
        work = {"flops": scd_flops(self.cfg) * n * self.batch,
                "fused_least_s_per_sample": flops.fused_least_s(self.cfg, self.batch) / self.batch}
        return Window(n * self.batch, 0, {"infer_samples_per_s": n * self.batch / elapsed},
                      n * self.batch, elapsed, {}, {}, work)

    def release(self) -> None:
        del self.predictor
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        z = reference_logits(self.cfg, self.params, self.pre, self.post, self.device)
        whole = [(ids, out) for ids, out in self.answers if all(k in out for k in MAPS)]
        mask, missing = compare.mask_checks([(ids, out["change"]) for ids, out in whole],
                                            z["change"].cpu().numpy(), self.limits,
                                            len(self.answers) - len(whole))
        gap = max(class_gap([(ids, out[k]) for ids, out in whole], z[k]) for k in ("pre", "post"))
        return [mask, Check("class_gap_logit", gap, self.limits["class_gap_logit"]), missing]
