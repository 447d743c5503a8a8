#!/usr/bin/env python3
"""Smoke run of change3d_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py [--batch 8] [--batches 3] [--seed 0]

Run from the repository root. Phases (any failure exits non-zero and prints
no result line):

1. build: compile every CUDA kernel from csrc/ (one nvcc per source, all
   started together) and print the card's name and power limit;
2. kernels: hold each kernel against its plain PyTorch version on the card
   at the four X3D-L stage shapes at 256^2 (T=3), with and without SE, at
   B=2, B=3 and --batch, over KERNEL_SEEDS seeds, in fp32 (TF32 off;
   |d| <= 1e-4 * (1 + |ref|)) and bf16 (|d| <= 2 bf16 ulps of
   max(|ref|, 1)); prints the worst |d| and the share of the limit it uses;
3. forward: build the full-width X3D-L BCD Change3D from a seed, run
   Predictor.predict_u8 on --batches batches of random uint8 256^2 pairs
   with every launch count reset just before, and require 37 fused_block_fwd
   and 18 fused_block_se_sums launches per forward; then hold the fp32
   probabilities of the fused model against fused_inference=False (1e-3)
   on a whole batch and report the bf16 mask agreement;
4. repros: hold the two repro kernels (ops/repros.py: dot_1d within two
   bf16 ulps, manual_dma exactly) against their plain versions at the
   repros' shapes over KERNEL_SEEDS seeds, then drive their entry point
   (``python -m change3d_tpu_torch.ops.repros``, in process) with their
   launch counts reset just before, and require a launch of each;
5. times: bf16 pairs/s of predict_u8 at --batch, with the fused blocks and
   with fused_inference=False in turns; each fused kernel's time per stage
   shape from CUDA events (on operands first held against the plain
   version), its launches per forward, its bound, its blocks per SM and its
   plain version's time; each repro kernel's time, bound, plain time and
   library time (torch.mul(x, 2.0) for manual_dma).

The last lines are the kernels JSON, the card line from nvidia-smi, and
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# NVIDIA H100 SXM peaks (data sheet, dense): HBM bytes/s, bf16 tensor-core
# flop/s, fp32 CUDA-core flop/s.
HBM_BYTES_S = 3.35e12
BF16_TC_FLOPS = 989e12
FP32_FLOPS = 67e12

# (name, H=W at 256^2 input, C, Ci, SE reduced dim, fwd launches per BCD
# forward, se_sums launches per BCD forward)
STAGES = (
    ("stage1", 128, 24, 54, 8, 4, 2),
    ("stage2", 64, 48, 108, 8, 9, 4),
    ("stage3", 32, 96, 216, 16, 24, 12),
    ("stage4", 16, 192, 432, 32, 0, 0),  # CC only: not on the BCD path
)
T = 3
# Phase 2 draws operands from this many seeds, from --seed on: the bf16
# limit's margin is read over all of them.
KERNEL_SEEDS = 3
SOURCE = "change3d_tpu_torch/csrc/fused_block.cu"
PALLAS = "change3d_tpu/ops/pallas/fused_block.py"
REPRO_SOURCE = "change3d_tpu_torch/csrc/repros.cu"
REPRO_PALLAS = "tests/manual_pallas_repros.py"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else "unknown"


def operands(rs, b, hw, c, ci, cr, dtype, dev, has_se):
    """Block operands at model scale: x >= 0 (it is a ReLU output),
    torch-default conv init, BN folds near identity."""
    u = lambda fan, *s: torch.from_numpy(rs.uniform(-1, 1, s).astype(np.float32) / math.sqrt(fan))
    n = lambda scale, base, *s: torch.from_numpy((base + scale * rs.randn(*s)).astype(np.float32))
    x = torch.from_numpy(np.abs(rs.randn(b, T, hw, hw, c)).astype(np.float32))
    ops = [x, u(c, c, ci), n(0.1, 1, ci), n(0.1, 0, ci), u(27, 3, 3, 3, ci), n(0.1, 1, ci),
           n(0.1, 0, ci), u(ci, ci, c), n(0.1, 1, c), n(0.1, 0, c)]
    ops = [o.to(dev) for o in ops]
    ops[0] = ops[0].to(dtype)
    se = (u(ci, ci, cr), n(0.1, 0, cr), u(cr, cr, ci), n(0.1, 0, ci)) if has_se else None
    return ops, None if se is None else tuple(s.to(dev) for s in se)


def within(got, ref, dtype):
    """(ok, max |d|, max |d| / limit) under the stated limit for the dtype:
    1e-4 * (1 + |ref|) in fp32, two bf16 ulps of max(|ref|, 1) in bf16."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    if dtype == torch.float32:
        tol = 1e-4 * (1 + ref.abs())
    else:
        tol = 2 * torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1.0))) - 7)
    used = float((d / tol).max())
    return used <= 1.0 and bool(torch.isfinite(got).all()), float(d.max()), used


def event_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(b, hw, c, ci, itemsize, *, sums, n_tiles):
    """Least time on the card: bytes over HBM rate, 1x1-conv flops over the
    bf16 tensor-core rate, 27 depthwise taps over the fp32 rate; the largest."""
    pix = b * T * hw * hw
    front_w = c * ci * itemsize + (27 + 4) * ci * 4
    if sums:
        nbytes = pix * c * itemsize + front_w + b * n_tiles * ci * 4
        conv = 2 * pix * c * ci
    else:
        nbytes = 2 * pix * c * itemsize + front_w + ci * c * itemsize + 2 * c * 4 + b * ci * 4
        conv = 4 * pix * c * ci
    times = {"bytes": nbytes / HBM_BYTES_S, "operations": max(conv / BF16_TC_FLOPS,
                                                              2 * 27 * pix * ci / FP32_FLOPS)}
    kind = max(times, key=times.get)
    return times[kind] * 1e3, kind


def hold(worst, key, what, got, ref, dtype):
    """Check got against ref, keep the worst |d| and share of the limit per
    (key, dtype), raise past the limit."""
    ok, err, used = within(got, ref, dtype)
    w = worst[key].setdefault(str(dtype).split(".")[-1], {"max_abs_err": 0.0, "limit_used": 0.0})
    w["max_abs_err"], w["limit_used"] = max(w["max_abs_err"], err), max(w["limit_used"], used)
    if not ok:
        raise AssertionError(f"{key} {what} {dtype}: max |d| {err}, {used:.3f} of the limit")


def check_block(fb, worst, what, ops, se, dtype, hw):
    """Both kernels against their plain versions on one block's operands."""
    gate = None
    if se is not None:
        ref_sums = fb.se_sums_reference(*ops[:7])
        hold(worst, "fused_block_se_sums", what, fb.fused_block_se_sums(*ops[:7]).sum(1)
             / (T * hw * hw), ref_sums.sum(1) / (T * hw * hw), dtype)
        gate = fb.se_gate(ref_sums.sum(1) / (T * hw * hw), *se)
    hold(worst, "fused_block_fwd", what, fb.fused_block_fwd(*ops, gate),
         fb.fused_block_fwd_reference(*ops, gate), dtype)
    if se is not None:  # the wrapper's own SE path end to end
        hold(worst, "fused_block_fwd", what + " sums->gate->fwd",
             fb.fused_bottleneck_block(*ops, se), fb.fused_block_reference(*ops, se), dtype)


def phase_kernels(fb, dev, seeds, batch):
    worst = {"fused_block_fwd": {}, "fused_block_se_sums": {}}
    for seed in seeds:
        rs = np.random.RandomState(seed)
        for name, hw, c, ci, cr, _, _ in STAGES:
            for b in sorted({2, 3, batch}):
                for has_se in (False, True):
                    for dtype in (torch.float32, torch.bfloat16):
                        ops, se = operands(rs, b, hw, c, ci, cr, dtype, dev, has_se)
                        check_block(fb, worst, f"{name} B={b} se={has_se} seed={seed}", ops, se,
                                    dtype, hw)
            print(f"kernels {name} seed {seed}: {json.dumps(worst)}", flush=True)
    return worst


def phase_forward(pkg, dev, batch, n_batches, seed):
    fb, Change3D, Task, Predictor, x3d_l_config = pkg
    model = Change3D(Task.BCD, device=dev, seed=seed)
    pred = Predictor(model, compute_dtype=torch.bfloat16, device=dev)
    rs = np.random.RandomState(seed)
    pairs = [tuple(rs.randint(0, 256, (batch, 256, 256, 3)).astype(np.uint8) for _ in range(2))
             for _ in range(n_batches)]
    pred.predict_u8(*pairs[0])  # load the kernels, warm the allocator

    fb.fused_block_fwd.launches = 0
    fb.fused_block_se_sums.launches = 0
    masks = [pred.predict_u8(pre, post)["change"] for pre, post in pairs]
    torch.cuda.synchronize()
    launches = {"fused_block_fwd": fb.fused_block_fwd.launches,
                "fused_block_se_sums": fb.fused_block_se_sums.launches}
    want = {"fused_block_fwd": 37 * n_batches, "fused_block_se_sums": 18 * n_batches}
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    for m in masks:
        if m.shape != (batch, 256, 256) or m.dtype != np.bool_:
            raise AssertionError(f"mask {m.shape} {m.dtype}")
    print(f"forward: {n_batches} batches of {batch} pairs, launches {launches}", flush=True)

    # fp32: fused kernels against the plain path on the same weights.
    plain = Change3D(Task.BCD, backbone_cfg=x3d_l_config(fused_inference=False), device=dev,
                     seed=seed)
    plain.load_state_dict(model.state_dict())
    pre, post = pairs[0]
    norm = lambda a: (a.astype(np.float32) / 255.0 - 0.5) / 0.5
    p_fused = Predictor(model, compute_dtype=torch.float32, device=dev).predict_probs(
        norm(pre), norm(post))["change"]
    p_plain = Predictor(plain, compute_dtype=torch.float32, device=dev).predict_probs(
        norm(pre), norm(post))["change"]
    err = float(np.abs(p_fused - p_plain).max())
    if not (np.isfinite(p_fused).all() and p_fused.shape == (batch, 256, 256, 1) and err <= 1e-3):
        raise AssertionError(f"fp32 fused vs plain probabilities: max |d| {err}")
    agree_fp32 = float((masks[0] == (p_plain[..., 0] > 0.5)).mean())
    plain_pred = Predictor(plain, compute_dtype=torch.bfloat16, device=dev)
    agree_bf16 = float((masks[0] == plain_pred.predict_u8(*pairs[0])["change"]).mean())
    stats = {"fp32_prob_max_abs_err": err, "prob_mean": float(p_plain.mean()),
             "changed_fraction": float((p_plain > 0.5).mean()),
             "bf16_mask_agreement_vs_fp32_plain": agree_fp32,
             "bf16_mask_agreement_vs_bf16_plain": agree_bf16}
    print(f"forward check: {json.dumps(stats)}", flush=True)
    return pred, plain_pred, pairs, launches, stats


def phase_repros(rp, dev, seeds):
    """The repro kernels against their plain versions, then their entry
    point as a user runs it, counted."""
    worst = {"dot_1d": {"max_abs_err": 0.0, "limit_used": 0.0},
             "manual_dma": {"max_abs_err": 0.0, "limit_used": 0.0}}
    for seed in seeds:
        x, w, xd = rp.repro_operands(seed, dev)
        got, want = rp.dot_1d(x, w), rp.dot_1d_reference(x, w)
        used = rp.bf16_ulps_used(got, want)
        err = float((got.float() - want.float()).abs().max())
        if used > 1.0 or not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"dot_1d seed {seed}: max |d| {err}, {used:.3f} of two bf16 ulps")
        w_ = worst["dot_1d"]
        w_["max_abs_err"], w_["limit_used"] = max(w_["max_abs_err"], err), max(w_["limit_used"], used)
        got = rp.manual_dma(xd)
        err = float((got - rp.manual_dma_reference(xd)).abs().max())
        if err != 0.0:
            raise AssertionError(f"manual_dma seed {seed}: max |d| {err}, must be exact")
    print(f"repros vs plain versions: {json.dumps(worst)}", flush=True)

    rp.dot_1d.launches = 0
    rp.manual_dma.launches = 0
    rp.main(seeds[0])
    torch.cuda.synchronize()
    launches = {"dot_1d": rp.dot_1d.launches, "manual_dma": rp.manual_dma.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"repro entry point launches {launches}")
    print(f"repros entry point: launches {launches}", flush=True)
    return worst, launches


def repro_rows(rp, dev, seed, card, iters=200):
    """Time, bound, plain and library time of each repro kernel at the
    repros' shapes."""
    x, w, xd = rp.repro_operands(seed, dev)
    r, c, n = x.shape[0], x.shape[1], w.shape[1]
    rows = []
    for kernel, fn, plain, library, nbytes, flops in (
        ("dot_1d", lambda: rp.dot_1d(x, w), lambda: rp.dot_1d_reference(x, w), None,
         (r * c + c * n + r * n) * 2, r * c + 2 * c * n),
        ("manual_dma", lambda: rp.manual_dma(xd), lambda: rp.manual_dma_reference(xd),
         lambda: torch.mul(xd, 2.0), 2 * xd.numel() * 4, xd.numel()),
    ):
        times = {"bytes": nbytes / HBM_BYTES_S, "operations": flops / FP32_FLOPS}
        by = max(times, key=times.get)
        rows.append({"kernel": kernel, "shape": list((x if kernel == "dot_1d" else xd).shape),
                     "ms": event_ms(fn, iters), "plain_ms": event_ms(plain, iters),
                     "library_ms": None if library is None else event_ms(library, iters),
                     "bound_ms": times[by] * 1e3, "bound_by": by})
        print(f"time {kernel} ({card}): {json.dumps(rows[-1])}", flush=True)
    return rows


def pairs_per_s(pred, pairs, batch, rounds=3):
    """End to end: uint8 host arrays in, bool masks out, host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        for pre, post in pairs:
            pred.predict_u8(pre, post)
    return rounds * len(pairs) * batch / (time.perf_counter() - t0)


def phase_times(fb, worst, pred, plain_pred, pairs, batch, dev, seed, card, iters=10):
    # The fused forward and the plain one (fused_inference=False) in turns:
    # fused, plain, plain, fused.
    for p in (pred, plain_pred):
        p.predict_u8(*pairs[0])
    runs = {"fused": [], "plain": []}
    for kind in ("fused", "plain", "plain", "fused"):
        runs[kind].append(pairs_per_s(pred if kind == "fused" else plain_pred, pairs, batch))
    dev_pre, dev_post = (torch.from_numpy(a).to(dev) for a in pairs[0])
    fwd_ms = {kind: event_ms(lambda: p.predict_u8_device(dev_pre, dev_post), 5)
              for kind, p in (("fused", pred), ("plain", plain_pred))}

    rs = np.random.RandomState(seed + 1)
    rows = []
    for name, hw, c, ci, cr, n_fwd, n_sums in STAGES:
        ops, se = operands(rs, batch, hw, c, ci, cr, torch.bfloat16, dev, True)
        check_block(fb, worst, f"{name} B={batch} timed operands", ops, se, torch.bfloat16, hw)
        gate = fb.se_gate(fb.se_sums_reference(*ops[:7]).sum(1) / (T * hw * hw), *se)
        _, _, _, _, n_tiles = fb.plan_tiles(T, hw, hw, c, ci, 2)
        for kernel, fn, plain, n_launch, sums in (
            ("fused_block_fwd", lambda: fb.fused_block_fwd(*ops, gate),
             lambda: fb.fused_block_fwd_reference(*ops, gate), n_fwd, False),
            ("fused_block_se_sums", lambda: fb.fused_block_se_sums(*ops[:7]),
             lambda: fb.se_sums_reference(*ops[:7]), n_sums, True),
        ):
            b_ms, b_by = bound(batch, hw, c, ci, 2, sums=sums, n_tiles=n_tiles)
            rows.append({"kernel": kernel, "stage": name, "shape": [batch, T, hw, hw, c],
                         "inner": ci, "launches_per_forward": n_launch,
                         "blocks_per_sm": fb.blocks_per_sm(torch.bfloat16, sums, T, hw, hw, c, ci),
                         "ms": event_ms(fn, iters), "plain_ms": event_ms(plain, 3),
                         "bound_ms": b_ms, "bound_by": b_by})
            print(f"time {kernel} {name} ({card}): {json.dumps(rows[-1])}", flush=True)
    return runs, fwd_ms, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8, help="pairs per forward for the timings")
    ap.add_argument("--batches", type=int, default=3, help="forwards in the launch-count run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "chip_smoke.json"))
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from change3d_tpu_torch.device import resolve_device
    from change3d_tpu_torch.inference import Predictor
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import x3d_l_config
    from change3d_tpu_torch.ops import cuda_build
    from change3d_tpu_torch.ops import fused_block as fb
    from change3d_tpu_torch.ops import repros as rp

    dev = resolve_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    reports = cuda_build.build()
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"build: {sorted(cuda_build.SIGNATURES)} in {time.perf_counter() - t0:.1f} s", flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)

    seeds = list(range(args.seed, args.seed + KERNEL_SEEDS))
    worst = phase_kernels(fb, dev, seeds, args.batch)
    pred, plain_pred, pairs, launches, stats = phase_forward(
        (fb, Change3D, Task, Predictor, x3d_l_config), dev, args.batch, args.batches, args.seed)
    repro_worst, repro_launches = phase_repros(rp, dev, seeds)
    runs, fwd_ms, rows = phase_times(fb, worst, pred, plain_pred, pairs, args.batch, dev,
                                     args.seed, card)
    rows += repro_rows(rp, dev, args.seed, card)
    print(f"kernels vs plain versions, worst over every check: {json.dumps(worst)}", flush=True)
    for kind in ("fused", "plain"):
        print(f"bcd predict_u8 bf16 256^2 batch {args.batch} {kind} blocks: "
              f"{runs[kind]} pairs/s end to end, {fwd_ms[kind]} ms per forward on the device "
              f"({card})", flush=True)

    kernels = []
    for kernel, replaces in (("fused_block_fwd", f"{PALLAS}:414 (also :216, :365)"),
                             ("fused_block_se_sums", f"{PALLAS}:199 (also :349)")):
        mine = [r for r in rows if r["kernel"] == kernel and r["launches_per_forward"]]
        total = lambda k: sum(r[k] * r["launches_per_forward"] for r in mine)
        by = {}
        for r in mine:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"] * r["launches_per_forward"]
        kernels.append({
            "name": kernel, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[kernel],
            "launches_per_forward": sum(r["launches_per_forward"] for r in mine),
            "max_abs_err": worst[kernel]["bfloat16"]["max_abs_err"],
            "limit_used": worst[kernel]["bfloat16"]["limit_used"],
            "max_abs_err_fp32": worst[kernel]["float32"]["max_abs_err"],
            "limit_used_fp32": worst[kernel]["float32"]["limit_used"],
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": max(by, key=by.get), "library_ms": None,
            "per": f"one bf16 BCD forward at batch {args.batch} (sum over its launches)",
        })
    for kernel, replaces in (("dot_1d", f"{REPRO_PALLAS}:25 (pallas_call :35)"),
                             ("manual_dma", f"{REPRO_PALLAS}:39 (pallas_call :48)")):
        row = next(r for r in rows if r["kernel"] == kernel)
        kernels.append({
            "name": kernel, "route": "cuda", "source": REPRO_SOURCE, "replaces": replaces,
            "launches": repro_launches[kernel],
            "max_abs_err": repro_worst[kernel]["max_abs_err"],
            "limit_used": repro_worst[kernel]["limit_used"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "per": f"one launch at {row['shape']}",
        })

    detail = {"card": card, "torch": torch.__version__, "batch": args.batch,
              "pairs_per_s": runs, "forward_ms": fwd_ms, "forward_check": stats,
              "rows": rows, "kernels": kernels}
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(detail, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
