"""Closed loop of batch prediction: ``Predictor.predict_u8`` called back to
back on batches of uint8 pairs held on the host, each batch drawn at set-up
from a seeded pool of pairs (traffic keys: ``batch``, ``pool``,
``batches``). Reports ``infer_samples_per_s``: pairs completed over the
whole window. Every answer of the window is kept and checked against the
fp32 reference's change logits of its pairs.

Variant (the control, never run by the benchmark itself): ``fp8`` the
reference with float8 products in the program's place."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.benchlib import compare, inputs, program
from benchmark.benchlib.controls import Fp8Predictor
from benchmark.benchlib.runner import Window
from benchmark.reference.change3d import make_params
from benchmark.work import flops


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
            self.predictor = Fp8Predictor(cfg, self.params, device)
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
            out = predict(*self.batches[k])
            self.answers.append((self.ids[k], out["change"]))
            n += 1
            now = time.perf_counter()
            tracer.tick(now, t0, n * self.batch, sync)
            if now - t0 >= seconds:
                break
        elapsed = now - t0
        work = {"flops": flops.detection_flops(self.cfg) * n * self.batch,
                "fused_least_s_per_sample": flops.fused_least_s(self.cfg, self.batch) / self.batch}
        return Window(n * self.batch, 0, {"infer_samples_per_s": n * self.batch / elapsed},
                      n * self.batch, elapsed, {}, {}, work)

    def release(self) -> None:
        del self.predictor
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        z = compare.reference_change_logits(self.cfg, self.params, self.pre, self.post,
                                            self.device)
        return compare.mask_checks(self.answers, z, self.limits)
