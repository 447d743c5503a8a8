#!/usr/bin/env python3
"""Where the time goes inside the two repro kernels on one NVIDIA GPU: SM
clock cycles between the phase marks (C3D_PHASE) of csrc/repros.cu.

    python3 tools/phase_clocks.py [--runs 20] [--seed 0]

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


def build(out_dir: str) -> str:
    from change3d_tpu_torch.ops import cuda_build

    os.makedirs(out_dir, exist_ok=True)
    target = os.path.join(out_dir, "repros-phase-clocks.so")
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-DC3D_PHASE_CLOCKS", "-o", target,
           str(cuda_build.CSRC_DIR / "repros.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    return target


def load(path: str) -> ctypes.CDLL:
    from change3d_tpu_torch.ops import cuda_build

    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in cuda_build.SIGNATURES["repros"].items():
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "phase_clocks.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phase_clocks: CUDA is not available; this tool needs an NVIDIA GPU", file=sys.stderr)
        return 2
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
