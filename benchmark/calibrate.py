#!/usr/bin/env python3
"""Calibration of the benchmark on the card, in one process per command (the
kernels build once); never run by the benchmark itself.

    python3 benchmark/calibrate.py controls --workload W --seeds 1,2,3 \
        --variants none,fp8 [--seconds 3]
    python3 benchmark/calibrate.py sweep --workload bcd-serve-poisson \
        --rates 60,80,100 [--seconds 10] [--seed 1]

``controls`` runs the cell's set-up, a short window and its check for
every seed and variant (``none``: the program as measured; ``fp8``: the
reference with float8 products in the program's place; ``token_altered``:
a planted fault of the caption cell) and prints one JSON line each with
the numbers compared. ``sweep`` runs the
serving cell's window at each offered rate and prints what it sustained.
Lines also go to ``chiprun_out/calibrate.jsonl``.
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.benchlib.manifest import ROOT, Cell  # noqa: E402
from benchmark.benchlib.runner import set_cache_dirs  # noqa: E402
from benchmark.benchlib.trace import Tracer  # noqa: E402


def emit(row: dict) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "calibrate.jsonl"), "a") as f:
        f.write(line + "\n")


def controls(args) -> None:
    cell = Cell(args.workload)
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            d = cell.driver().Driver(cell, seed, "cuda", variant=None if variant == "none"
                                     else variant)
            win = d.window(args.seconds, Tracer(False, 0, 0))
            d.release()
            checks = d.check()
            emit({"workload": args.workload, "variant": variant, "seed": seed,
                  "checks": {c.name: c.value for c in checks}, "metrics": win.metrics,
                  "failed": win.failed, "seconds": time.perf_counter() - t})
            del d


def sweep(args) -> None:
    import numpy as np

    cell = Cell(args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        d = cell.driver().Driver(cell, args.seed, "cuda", rate=rate)
        win = d.window(args.seconds, Tracer(False, 0, 0))
        d.release()
        res = d.result
        lat = np.sort(res["latency"][~np.isnan(res["latency"])])
        due = res["due"]
        ends = due[~np.isnan(res["latency"])] + res["latency"][~np.isnan(res["latency"])]
        q = lambda p: float(lat[max(0, math.ceil(p * len(lat)) - 1)]) * 1e3 if len(lat) else None
        emit({"workload": args.workload, "rate_per_s": rate, "requests": len(due),
              "failed": win.failed, "completed_per_s": len(lat) / float(ends.max()) if len(lat)
              else 0.0, "p50_ms": q(0.5), "p95_ms": q(0.95), "p99_ms": q(0.99),
              "last_tenth_p95_ms": q(0.95) if not len(lat) else float(np.percentile(
                  res["latency"][int(0.9 * len(due)):], 95)) * 1e3,
              "batch_fill": win.counters["batched_requests"] / max(1, win.counters["batches"])})
        del d


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("controls")
    c.add_argument("--workload", required=True)
    c.add_argument("--seeds", required=True)
    c.add_argument("--variants", default="none")
    c.add_argument("--seconds", type=float, default=3.0)
    s = sub.add_parser("sweep")
    s.add_argument("--workload", default="bcd-serve-poisson")
    s.add_argument("--rates", required=True)
    s.add_argument("--seconds", type=float, default=10.0)
    s.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    set_cache_dirs()
    controls(args) if args.cmd == "controls" else sweep(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
