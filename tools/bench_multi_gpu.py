#!/usr/bin/env python3
"""Multi-GPU timings of change3d_tpu_torch on the full-width X3D-L BCD model
(bf16, 256², seeded random weights and pairs), one process per card over
NCCL, as ``cli bcd --num_processes N`` runs:

    python3 tools/bench_multi_gpu.py [--out DETAILS.json]

On one card and on every card, at global batches 16 and 64: train
samples/s by host clock over 10 steps after 3 warm-up steps
(``train_step``, every process on its slice, the step's all-reduces
included), the device time of the step's NCCL kernels and of all its
kernels from a ``WindowTracer`` trace of 3 steps on process 0 (the
``--profile_dir`` tracer), peak memory, and validation pairs/s through
``eval_step`` (10 batches). Then a ``shard=True``
``Predictor`` over every card against one card's: ``predict_u8`` pairs/s
at batch 32 (turns one, all, all, one), its masks against one card's on
the same slices and on the whole batch. Every result names the cards and
their power limits; a configuration that does not fit reports the error.
``--out`` also writes the details as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARMUP, STEPS, TRACED, EVAL_STEPS = 3, 10, 3, 10
BATCHES = (16, 64)
SHARD_BATCH, SHARD_ROUNDS = 32, 5


def cards_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().replace("\n", "; ")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def global_batch(b: int, seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)
    pre, post = (rs.standard_normal((b, 256, 256, 3)).astype(np.float32) for _ in range(2))
    label = (rs.rand(b, 256, 256, 1) > 0.8).astype(np.int32)
    return {"pre": pre, "post": post, "label": label}


def nccl_and_total_us(trace_path: str):
    with open(trace_path) as f:
        kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    nccl = sum(float(e.get("dur", 0)) for e in kernels if "nccl" in e["name"].lower())
    return nccl, sum(float(e.get("dur", 0)) for e in kernels), len(kernels)


def train_worker(rank, n, port, batch, out, trace_dir):
    sys.path.insert(0, REPO)
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.parallel import distributed
    from change3d_tpu_torch.train.engine import eval_step, train_step
    from change3d_tpu_torch.train.optim import torch_adam
    from change3d_tpu_torch.utils.profiling import WindowTracer

    distributed.initialize(f"127.0.0.1:{port}", n, rank, device="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    result = {"cards": n, "global_batch": batch, "local_batch": batch // n}
    try:
        model = Change3D(Task.BCD, device=dev, seed=0)
        opt = torch_adam(model.parameters(), weight_decay=1e-4)
        k = batch // n
        data = {key: torch.from_numpy(v[rank * k:(rank + 1) * k]).to(dev)
                for key, v in global_batch(batch).items()}
        step = lambda i: train_step(model, opt, lambda _: 2e-4, data, i,
                                    compute_dtype=torch.bfloat16)
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(WARMUP):
            step(i)
        torch.cuda.synchronize(dev)
        distributed.barrier()
        t0 = time.perf_counter()
        for i in range(STEPS):
            step(WARMUP + i)
        torch.cuda.synchronize(dev)
        distributed.barrier()
        seconds = time.perf_counter() - t0
        result.update(train_samples_per_s=batch * STEPS / seconds,
                      ms_per_step=1e3 * seconds / STEPS,
                      peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        tracer = WindowTracer(trace_dir if rank == 0 else None, start=0, n=TRACED, device=dev)
        for i in range(TRACED + 1):
            tracer.tick(i)
            if i < TRACED:
                step(WARMUP + STEPS + i)
        tracer.close()
        if rank == 0:
            nccl_us, total_us, events = nccl_and_total_us(tracer.path)
            result.update(nccl_ms_per_step=nccl_us / 1e3 / TRACED,
                          kernel_ms_per_step=total_us / 1e3 / TRACED, kernel_events=events)
        eval_step(model, data, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize(dev)
        distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(EVAL_STEPS):
            eval_step(model, data, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize(dev)
        distributed.barrier()
        result["val_pairs_per_s"] = batch * EVAL_STEPS / (time.perf_counter() - t0)
    except torch.cuda.OutOfMemoryError as e:
        result["error"] = f"out of memory: {str(e).splitlines()[0]}"
    if rank == 0:
        with open(out, "w") as f:
            json.dump(result, f)
    distributed.shutdown()


def shard_rows(n: int):
    sys.path.insert(0, REPO)
    from change3d_tpu_torch.inference import Predictor
    from change3d_tpu_torch.models.trainer import Change3D, Task

    one = Predictor(Change3D(Task.BCD, device="cuda:0", seed=0))
    every = Predictor(Change3D(Task.BCD, device="cuda:0", seed=0), shard=True)
    rs = np.random.RandomState(1)
    pre, post = (rs.randint(0, 256, (SHARD_BATCH, 256, 256, 3)).astype(np.uint8)
                 for _ in range(2))
    got, whole = every.predict_u8(pre, post), one.predict_u8(pre, post)
    k = SHARD_BATCH // len(every.devices)
    parts = [one.predict_u8(pre[i:i + k], post[i:i + k]) for i in range(0, SHARD_BATCH, k)]
    equal = all(np.array_equal(got[key], np.concatenate([p[key] for p in parts]))
                for key in got)
    # One card at the whole batch may pick other bf16 conv algorithms.
    differing = int(sum((got[key] != whole[key]).sum() for key in got))
    rows = {"one card": [], f"{len(every.devices)} cards": []}
    for name, pred in (("one card", one), (f"{len(every.devices)} cards", every),
                       (f"{len(every.devices)} cards", every), ("one card", one)):
        t0 = time.perf_counter()
        for _ in range(SHARD_ROUNDS):
            pred.predict_u8(pre, post)
        rows[name].append(SHARD_ROUNDS * SHARD_BATCH / (time.perf_counter() - t0))
    return {"batch": SHARD_BATCH, "pairs_per_s": rows, "masks_equal_per_slice": equal,
            "pixels_differing_from_one_card_at_the_whole_batch": differing}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the details here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_multi_gpu: CUDA is not available", file=sys.stderr)
        return 2
    count = torch.cuda.device_count()
    card = cards_line()
    print(f"cards: {card}", flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for n in sorted({1, count}):
            for batch in BATCHES:
                out = os.path.join(tmp, f"{n}-{batch}.json")
                trace_dir = os.path.join(tmp, f"trace-{n}-{batch}")
                mp.spawn(train_worker, args=(n, free_port(), batch, out, trace_dir), nprocs=n)
                with open(out) as f:
                    rows.append(json.load(f))
                print(f"BCD train bf16 256² on {n} card(s), global batch {batch} ({card}): "
                      f"{json.dumps(rows[-1])}", flush=True)
    shard = shard_rows(count)
    print(f"sharded Predictor.predict_u8 bf16 256² batch {SHARD_BATCH} ({card}): "
          f"{json.dumps(shard)}", flush=True)
    if not args.out:
        return 0
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"cards": card, "torch": torch.__version__, "train": rows, "shard": shard},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
