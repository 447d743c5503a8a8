"""Closed loop of Kinetics video classification: ``ClipClassifier.classify_u8``
on the X3D-L classifier called back to back, one video's views a call, on
batches of uint8 clips held on the host, each batch drawn at set-up from a
seeded pool of clips (traffic keys: ``batch``, ``pool``, ``batches``).
Reports ``infer_samples_per_s``: clips completed over the whole window.

Every answer of the window is kept and checked against the fp32 reference's
logits of its clips (``reference/x3d_kinetics.py``), in units of each
clip's reference logit standard deviation over the classes: the widest
|served - reference| logit (``logit_gap``), the reference's best logit less
its logit at the served argmax (``top1_gap``), and the answers without a
finite row of logits for each clip (``answers_missing``).

Variant (the control, never run by the benchmark itself): ``fp8`` the
reference with float8 products in the program's place."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.benchlib import compare, inputs
from benchmark.benchlib.runner import Check, Window
from benchmark.reference.x3d_kinetics import KineticsRef, make_params, normalize_u8
from benchmark.work import kinetics

# Clips of the pool the reference takes at once.
REF_BLOCK = 6
# The least mean spread of a clip's logits over the classes: below it the
# logits have collapsed and the check would compare nothing.
MIN_LOGIT_STD = 1e-3


def clips(seed: int, count: int, frames: int, size: int) -> np.ndarray:
    """``count`` uint8 [frames, size, size, 3] clips: a blocky texture of its
    own tint and contrast panning by up to one pixel a frame, with noise."""
    r = inputs.rng(seed, "clips")
    cell, margin = 8, frames
    side = size + margin
    base = r.integers(0, 256, (count, -(-side // cell), -(-side // cell), 3), dtype=np.uint8)
    base = np.repeat(np.repeat(base, cell, axis=1), cell, axis=2)[:, :side, :side]
    contrast = r.uniform(0.4, 1.0, (count, 1, 1, 1)).astype(np.float32)
    tint = r.uniform(-60, 60, (count, 1, 1, 3)).astype(np.float32)
    base = np.clip((base.astype(np.float32) - 128) * contrast + 128 + tint, 0, 224).astype(np.uint8)
    velocity = r.integers(-1, 2, (count, 2))
    out = r.integers(0, 32, (count, frames, size, size, 3), dtype=np.uint8)
    for i in range(count):
        for t in range(frames):
            y, x = (margin // 2 + t * velocity[i] - velocity[i] * (frames // 2)).tolist()
            out[i, t] += base[i, y:y + size, x:x + size]
    return out


def build_classifier(cfg: dict, params, device):
    """The port's ``X3D(..., head=True)`` for ``cfg`` on ``device`` holding
    ``params`` (every key of its state_dict)."""
    from change3d_tpu_torch.models.x3d import X3D, X3DConfig

    backbone = X3DConfig(
        stem_dim_out=cfg["stem_dim"], stage_dims=tuple(cfg["stage_dims"]),
        stage_inner_dims=tuple(cfg["stage_inner_dims"]), stage_depths=tuple(cfg["stage_depths"]),
        stem_conv_stride=tuple(cfg["stem_stride"]), se_ratio=cfg["se_ratio"],
        bn_eps=cfg["bn_eps"], head_dim_out=cfg["head_dim_out"], num_classes=cfg["num_classes"])
    model = X3D(backbone, head=True).to(device)
    model.load_state_dict(params, strict=True)
    return model


class Fp8Classifier:
    """``ClipClassifier.classify_u8`` computed by the reference with float8
    products."""

    def __init__(self, cfg, params, device):
        self.ref, self.device = KineticsRef(cfg, params, quant="fp8"), device

    def classify_u8(self, batch: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(batch).to(self.device)
        return compare.reference_in_blocks(lambda s: self.ref.logits(normalize_u8(x[s])),
                                           len(x), REF_BLOCK)


def reference_logits(cfg: dict, params, pool: np.ndarray, device) -> np.ndarray:
    """The fp32 reference's logits [N, classes] of uint8 clips, computed on
    ``device`` in blocks of REF_BLOCK clips."""
    ref = KineticsRef(cfg, params)
    return compare.reference_in_blocks(
        lambda s: ref.logits(normalize_u8(torch.from_numpy(pool[s]).to(device))), len(pool),
        REF_BLOCK)


def logit_checks(answers, ref: np.ndarray, limits: dict):
    """Served logits against the reference's [N, classes]. ``answers``:
    (clip ids, fp32 logits [n, classes]) per answer."""
    sigma, best = ref.std(-1), ref.max(-1)
    logit_gap = top1_gap = 0.0
    missing = 0
    for ids, served in answers:
        served = np.asarray(served)
        if served.shape != (len(ids), ref.shape[1]) or not np.isfinite(served).all():
            missing += 1
            continue
        z, s = ref[ids], sigma[ids]
        logit_gap = max(logit_gap, float((np.abs(served - z) / s[:, None]).max()))
        picked = z[np.arange(len(ids)), served.argmax(-1)]
        top1_gap = max(top1_gap, float(((best[ids] - picked) / s).max()))
    return [Check("logit_gap", logit_gap, limits["logit_gap"]),
            Check("top1_gap", top1_gap, limits["top1_gap"]),
            Check("answers_missing", float(missing), 0.0)]


class Driver:
    def __init__(self, cell, seed: int, device: str, variant=None):
        # The program's entry point first: a tree without it fails here at once.
        from change3d_tpu_torch.inference import ClipClassifier

        cfg, tr = cell.config, cell.traffic
        self.cfg, self.limits, self.device = cfg, cell.limits, device
        self.batch = tr["batch"]
        self.params = make_params(cfg, seed, device)
        self.pool = clips(seed, tr["pool"], cfg["frames"], cfg["crop"])
        draw = inputs.rng(seed, "batches")
        self.ids = [np.sort(draw.choice(tr["pool"], self.batch, replace=False))
                    for _ in range(tr["batches"])]
        self.batches = [self.pool[i] for i in self.ids]
        if variant == "fp8":
            self.classifier = Fp8Classifier(cfg, self.params, device)
        else:
            self.classifier = ClipClassifier(
                build_classifier(cfg, self.params, device),
                compute_dtype=getattr(torch, cfg["inference_dtype"]), device=device)
        warm = [self.classifier.classify_u8(b) for b in self.batches[:2]]
        spread = float(np.mean([w.std(-1).mean() for w in warm]))
        if not spread >= MIN_LOGIT_STD:
            raise RuntimeError(f"the logits have collapsed: mean per-clip std {spread} over the "
                               f"classes, below {MIN_LOGIT_STD}")
        self.answers = []

    def window(self, seconds: float, tracer) -> Window:
        sync = torch.cuda.synchronize if self.device == "cuda" else None
        classify = self.classifier.classify_u8
        n, t0 = 0, time.perf_counter()
        while True:
            k = n % len(self.batches)
            self.answers.append((self.ids[k], classify(self.batches[k])))
            n += 1
            now = time.perf_counter()
            tracer.tick(now, t0, n * self.batch, sync)
            if now - t0 >= seconds:
                break
        elapsed = now - t0
        work = {"flops": kinetics.clip_flops(self.cfg) * n * self.batch,
                "fused_least_s_per_sample": kinetics.fused_least_s(self.cfg, self.batch)
                / self.batch}
        return Window(n * self.batch, 0, {"infer_samples_per_s": n * self.batch / elapsed},
                      n * self.batch, elapsed, {}, {}, work)

    def release(self) -> None:
        del self.classifier
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        z = reference_logits(self.cfg, self.params, self.pool, self.device)
        return logit_checks(self.answers, z, self.limits)
