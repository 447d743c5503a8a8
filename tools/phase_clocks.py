#!/usr/bin/env python3
"""Where the time goes inside the repro kernels or the fused block kernels
on one NVIDIA GPU: SM clock cycles between the phase marks (C3D_PHASE) of
csrc/repros.cu or csrc/fused_block.cu.

    python3 tools/phase_clocks.py [--runs 20] [--seed 0]
    python3 tools/phase_clocks.py --fused [--batch 16] [--runs 20]
    python3 tools/phase_clocks.py --fused --kinetics [--batch 30] [--runs 20]

Builds csrc/repros.cu with -DC3D_PHASE_CLOCKS into a library of its own in
change3d_tpu_torch/_build/ (thread 0 of each of the first 8 blocks records
its SM's clock64() at every mark), launches each kernel at the repros'
shapes through its C entry point, and after each of --runs launches (each
after 20 warm-up launches, so the operands sit in L2 as in chip_smoke.py's
timings) reads the clocks back. Prints, per kernel, the median cycles of
each phase over runs and blocks, the median total, the device time per
launch of the instrumented build and of the wrapper's build on the
profiler's timeline (chip_smoke.device_ms; their difference is what the
marks cost), the card's SM clock and power (nvidia-smi) and its name and
power limit; writes the same to chiprun_out/phase_clocks.json. Exits
non-zero when there is no card.

With --fused it builds csrc/fused_block.cu so, loads that library in place
of the wrapper's (``cuda_build.load``), and launches ``fused_block_fwd`` and
``fused_block_se_sums`` at stage 3 of the X3D-L clips (T = 3, 4, 5 at
--batch) under both designs' plans (``plan_block``'s weight-resident one
and the staged ``_plan_bf16``): the marks of one tile of each of the first
8 blocks of sample 0 (of a persistent block, its group 0's last tile), the
phases of the first and of the last chunk of Ci, per design, kernel and
clip. Writes chiprun_out/phase_clocks_fused.json. With --kinetics it runs
instead X3D-L's two T-tiled Kinetics shapes (stage 3, 16 x 20^2, and stage
4, 16 x 10^2, both in T-tiles) for both kernels (--batch 30: one video's
views): the staged T-tiled kernel (``_plan_bf16``), and ``plan_block``'s
split design as its two launches apart, the xa pass (its marks 0-3) and
the tail on the xa pass's output, each with its device ms, and the whole
op (xa pass and tail). Writes chiprun_out/phase_clocks_kinetics.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# The phases between consecutive marks of each kernel in csrc/repros.cu.
PHASES = {
    "dot_1d": ("w copy issue, x loads and per-thread column sums",
               "sums of the lanes into the block's partials",
               "cluster barrier (arrive.release, wait.acquire)",
               "8 partials from distributed shared memory, mean",
               "relaxed arrive, wait for w's bulk copy",
               "product s @ w, warp sums, bf16 row",
               "16-byte stores of the row",
               "final cluster wait"),
    "manual_dma": ("barrier init, copy issue, __syncthreads",
                   "wait for the first chunk's bulk copy",
                   "2x and 16-byte stores of every chunk"),
}


# The fused block kernels' marks: (phase, mark at its start, mark at its end,
# whether only fused_block_fwd has it). Per tile 0 and 1 bound the x tile's
# issue; each chunk of Ci runs weights-and-barrier, conv_a, taps, conv_c or
# the sums (marks 2-5 after the first chunk's phases, 10-13 after the
# last's, 14 at the last's start); fwd's epilogue ends at 6, its stores at
# 7. A persistent block marks 8 at its start and 9 once its weights are in.
FUSED_PHASES = (
    ("x tile issue", 0, 1, False),
    ("first chunk: weights staged, x landed, barrier", 1, 2, False),
    ("first chunk: conv_a", 2, 3, False),
    ("first chunk: taps", 3, 4, False),
    ("first chunk: conv_c or sums", 4, 5, False),
    ("last chunk: weights staged, barrier", 14, 10, False),
    ("last chunk: conv_a", 10, 11, False),
    ("last chunk: taps", 11, 12, False),
    ("last chunk: conv_c or sums", 12, 13, False),
    ("epilogue: BN_c, residual, ReLU", 13, 6, True),
    ("stores", 6, 7, True),
)
RESIDENT_PHASE = ("weights resident (once a block)", 8, 9)
# A split tail has no conv_a and no weight staging: its chunk's copy has
# landed at the barrier, and it issues the next chunk's copy where a staged
# tile computes conv_a.
SPLIT_NAMES = {"first chunk: weights staged, x landed, barrier":
               "first chunk: x core and xa chunk landed, barrier",
               "first chunk: conv_a": "first chunk: next chunk's copy issued",
               "last chunk: weights staged, barrier": "last chunk: xa chunk landed, barrier",
               "last chunk: conv_a": "last chunk: (no copy)"}
# The xa pass (fused_block_xa_kernel): marks 0-3 of each of its first blocks.
XA_PHASES = (("x rows and the first slab's w_a columns landed", 0, 1),
             ("first slab's products", 1, 2),
             ("first slab's epilogue and stores, then the other slabs", 2, 3))
# Stage 3 of X3D-L at 256^2: (H = W, C, Ci, Cr).
STAGE3 = (32, 96, 216, 16)
# X3D-L's T-tiled Kinetics shapes (16 x 312^2 clips): (stage, T, H = W, C, Ci, Cr).
KINETICS = (("stage3", 16, 20, 96, 216, 16), ("stage4", 16, 10, 192, 432, 32))


def build(out_dir: str, name: str = "repros") -> str:
    from change3d_tpu_torch.ops import cuda_build

    os.makedirs(out_dir, exist_ok=True)
    target = os.path.join(out_dir, f"{name}-phase-clocks.so")
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-DC3D_PHASE_CLOCKS", "-o", target,
           str(cuda_build.CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    return target


def load(path: str, name: str = "repros") -> ctypes.CDLL:
    from change3d_tpu_torch.ops import cuda_build

    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in cuda_build.SIGNATURES[name].items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    lib.c3d_phase_clocks.argtypes, lib.c3d_phase_clocks.restype = [ctypes.c_void_p], ctypes.c_int
    return lib


def phase_cycles(lib, launch, n_marks: int, blocks: int, runs: int) -> np.ndarray:
    """[runs * blocks, n_marks - 1] cycles between consecutive marks."""
    rows = []
    clocks = np.zeros((8, 16), np.int64)
    for _ in range(runs):
        for _ in range(20):
            launch()
        torch.cuda.synchronize()
        clocks[:] = 0
        err = lib.c3d_phase_clocks(clocks.ctypes.data)
        if err:
            raise RuntimeError(f"reading the phase clocks: CUDA error {err}")
        rows.append(np.diff(clocks[:blocks, :n_marks], axis=1))
    return np.concatenate(rows)


def marks(lib, launch, runs: int) -> np.ndarray:
    """[runs, 8, 16] clocks of the first 8 blocks after each of ``runs``
    launches (each after 20 warm-up launches)."""
    out = []
    clocks = np.zeros((8, 16), np.int64)
    for _ in range(runs):
        for _ in range(20):
            launch()
        torch.cuda.synchronize()
        err = lib.c3d_phase_clocks(clocks.ctypes.data)
        if err:
            raise RuntimeError(f"reading the phase clocks: CUDA error {err}")
        out.append(clocks.copy())
    return np.stack(out)


def kinetics_main(args, lib, plain_lib, card, fb, cuda_build, chip_smoke, dev) -> dict:
    """--fused --kinetics: the staged kernel, the xa pass and the split tail
    at X3D-L's T-tiled Kinetics shapes."""
    result = {"card": card, "batch": args.batch, "rows": []}

    def clocked(launch, phases, end):
        cuda_build._LOADED["fused_block"] = lib
        try:
            clocks = marks(lib, launch, args.runs)
            ms_instrumented = chip_smoke.device_ms(launch, 50)
        finally:
            cuda_build._LOADED["fused_block"] = plain_lib
        return {"phases_median_cycles": {name: float(np.median(clocks[:, :, b] - clocks[:, :, a]))
                                         for name, a, b in phases},
                "tile_median_cycles": float(np.median(clocks[:, :, end] - clocks[:, :, 0])),
                "samples": int(clocks.shape[0] * clocks.shape[1]),
                "ms_instrumented": ms_instrumented, "ms_wrapper": chip_smoke.device_ms(launch, 50)}

    for stage, t, hw, c, ci, cr in KINETICS:
        ops, se = chip_smoke.operands(np.random.RandomState(args.seed + c), args.batch, t, hw, c,
                                      ci, cr, torch.bfloat16, dev, True)
        gate = fb.se_gate(fb.se_sums_reference(*ops[:7]).sum(1) / (t * hw * hw), *se)
        staged, split = fb._plan_bf16(t, hw, hw, c, ci), fb.plan_block(t, hw, hw, c, ci, 2)
        assert split.split and staged.tt == split.tt < t
        front = fb._front_args(*ops[:7])
        xa = fb._launch_xa(*front[:4])
        row = {"kernel": "fused_block_xa", "stage": stage, "t": t, "hw": hw,
               **clocked(lambda: fb._launch_xa(*front[:4]), XA_PHASES, 3)}
        result["rows"].append(row)
        print(f"fused_block_xa {stage} T={t} B={args.batch} ({card}): {json.dumps(row)}",
              flush=True)
        for kernel in ("fused_block_fwd", "fused_block_se_sums"):
            fwd = kernel == "fused_block_fwd"
            phases = [(name, a, b) for name, a, b, fwd_only in FUSED_PHASES if fwd or not fwd_only]
            for design, plan, launch in (
                ("staged", staged, (lambda: fb._launch_fwd(*ops, gate, plan=staged)) if fwd
                 else (lambda: fb._launch_se_sums(*ops[:7], plan=staged))),
                ("split tail", split, (lambda: fb._launch_fwd(*ops, gate, plan=split, xa=xa))
                 if fwd else (lambda: fb._launch_se_sums(*ops[:7], plan=split, xa=xa))),
            ):
                named = [(SPLIT_NAMES.get(n, n) if plan.split else n, a, b) for n, a, b in phases]
                row = {"kernel": kernel, "design": design, "stage": stage, "t": t, "hw": hw,
                       "plan": plan._asdict(), **clocked(launch, named, 7 if fwd else 13)}
                if plan.split:
                    whole = ((lambda: fb._launch_fwd(*ops, gate, plan=split)) if fwd
                             else (lambda: fb._launch_se_sums(*ops[:7], plan=split)))
                    row["ms_xa_and_tail"] = chip_smoke.device_ms(whole, 50)
                result["rows"].append(row)
                print(f"{kernel} {design} {stage} T={t} B={args.batch} ({card}): "
                      f"{json.dumps(row)}", flush=True)
        del ops, xa, front
        torch.cuda.empty_cache()
    return result


def fused_main(args) -> int:
    import chip_smoke
    from change3d_tpu_torch.device import resolve_device
    from change3d_tpu_torch.ops import cuda_build
    from change3d_tpu_torch.ops import fused_block as fb

    dev = resolve_device("cuda")
    plain_lib = cuda_build.load("fused_block")
    lib = load(build(str(cuda_build.BUILD_DIR), "fused_block"), "fused_block")
    card = chip_smoke.card_line()
    smi_before = chip_smoke.smi_sample()
    hw, c, ci, cr = STAGE3
    result = {"card": card, "batch": args.batch, "stage": list(STAGE3), "rows": []}
    if args.kinetics:
        result = kinetics_main(args, lib, plain_lib, card, fb, cuda_build, chip_smoke, dev)
    for t in () if args.kinetics else (3, 4, 5):
        ops, se = chip_smoke.operands(np.random.RandomState(args.seed + t), args.batch, t, hw, c,
                                      ci, cr, torch.bfloat16, dev, True)
        gate = fb.se_gate(fb.se_sums_reference(*ops[:7]).sum(1) / (t * hw * hw), *se)
        plans = {fb.plan_block(t, hw, hw, c, ci, 2), fb._plan_bf16(t, hw, hw, c, ci)}
        for plan, kernel in [(p, k) for p in sorted(plans, key=lambda p: p.resident)
                             for k in ("fused_block_fwd", "fused_block_se_sums")]:
            if kernel == "fused_block_fwd":
                launch = lambda: fb._launch_fwd(*ops, gate, plan=plan)
            else:
                launch = lambda: fb._launch_se_sums(*ops[:7], plan=plan)
            cuda_build._LOADED["fused_block"] = lib
            try:
                clocks = marks(lib, launch, args.runs)
                ms_instrumented = chip_smoke.device_ms(launch, 50)
            finally:
                cuda_build._LOADED["fused_block"] = plain_lib
            phases = [(name, a, b) for name, a, b, fwd_only in FUSED_PHASES
                      if kernel == "fused_block_fwd" or not fwd_only]
            if plan.resident:
                phases.insert(0, RESIDENT_PHASE)
            end = 7 if kernel == "fused_block_fwd" else 13
            row = {"kernel": kernel, "t": t, "plan": plan._asdict(),
                   "phases_median_cycles": {
                       name: float(np.median(clocks[:, :, b] - clocks[:, :, a]))
                       for name, a, b in phases},
                   "tile_median_cycles": float(np.median(clocks[:, :, end] - clocks[:, :, 0])),
                   "samples": int(clocks.shape[0] * clocks.shape[1]),
                   "ms_instrumented": ms_instrumented,
                   "ms_wrapper": chip_smoke.device_ms(launch, 50)}
            result["rows"].append(row)
            design = "resident" if plan.resident else "staged"
            print(f"{kernel} {design} T={t} B={args.batch} ({card}): {json.dumps(row)}",
                  flush=True)
    result["nvidia_smi"] = {"clocks_sm,power_draw,power_limit": {"before": smi_before,
                                                                 "after": chip_smoke.smi_sample()}}
    print(f"nvidia-smi: {json.dumps(result['nvidia_smi'])}")
    out = args.out or os.path.join(
        "chiprun_out", "phase_clocks_kinetics.json" if args.kinetics else "phase_clocks_fused.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused", action="store_true", help="the fused block kernels at stage 3")
    ap.add_argument("--kinetics", action="store_true",
                    help="with --fused: the staged kernel, the xa pass and the split tail at "
                         "X3D-L's T-tiled Kinetics shapes")
    ap.add_argument("--batch", type=int, default=None, help="16 (--fused), 30 (--kinetics)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phase_clocks: CUDA is not available; this tool needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.batch is None:
        args.batch = 30 if args.kinetics else 16
    if args.fused:
        return fused_main(args)
    args.out = args.out or os.path.join("chiprun_out", "phase_clocks.json")
    import chip_smoke
    from change3d_tpu_torch.device import resolve_device
    from change3d_tpu_torch.ops import cuda_build
    from change3d_tpu_torch.ops import repros as rp

    dev = resolve_device("cuda")
    lib = load(build(str(cuda_build.BUILD_DIR)))
    x, w, xd = rp.repro_operands(args.seed, dev)
    (r, c), n = x.shape, w.shape[1]
    out, outd = torch.empty((r, n), device=dev, dtype=torch.bfloat16), torch.empty_like(xd)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    plan = rp.manual_dma_plan(*xd.shape, sms)

    def dot():
        cuda_build.check(lib, lib.c3d_dot_1d(x.data_ptr(), w.data_ptr(), out.data_ptr(), r, c, n,
                                             stream), "dot_1d")

    def dma():
        cuda_build.check(lib, lib.c3d_manual_dma(xd.data_ptr(), outd.data_ptr(), *xd.shape, *plan,
                                                 stream), "manual_dma")

    card = chip_smoke.card_line()
    smi_before = chip_smoke.smi_sample()
    result = {"card": card, "shapes": {"dot_1d": [r, c, n], "manual_dma": list(xd.shape)},
              "manual_dma_plan": plan._asdict(), "kernels": {}}
    for kernel, launch, wrapper, blocks in (
        ("dot_1d", dot, lambda: rp.dot_1d(x, w), rp.DOT_RANKS),
        ("manual_dma", dma, lambda: rp.manual_dma(xd), min(8, plan.grid)),
    ):
        names = PHASES[kernel]
        cycles = phase_cycles(lib, launch, len(names) + 1, blocks, args.runs)
        med = np.median(cycles, axis=0)
        result["kernels"][kernel] = {
            "phases_median_cycles": {name: float(v) for name, v in zip(names, med)},
            "total_median_cycles": float(np.median(cycles.sum(axis=1))),
            "samples": int(cycles.shape[0]),
            "ms_instrumented": chip_smoke.device_ms(launch, 200),
            "ms_wrapper": chip_smoke.device_ms(wrapper, 200),
        }
        print(f"{kernel} ({card}): {json.dumps(result['kernels'][kernel])}", flush=True)
    result["nvidia_smi"] = {"clocks_sm,power_draw,power_limit": {"before": smi_before,
                                                                 "after": chip_smoke.smi_sample()}}
    print(f"nvidia-smi: {json.dumps(result['nvidia_smi'])}")
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
