#!/usr/bin/env python3
"""Count how often a gloo process that leaves by an error dies by SIGABRT.

    python3 tools/gloo_exit_abort.py [--runs 192] [--at-once 8] [--no-exit-hook]

Each run starts two processes on the CPU that join a gloo group through
``change3d_tpu_torch.parallel.distributed.initialize`` (3 s timeout, as the
lost-process test gives it). Process 1 leaves at once by ``SystemExit(3)``;
process 0 posts 32 sends of 256 KB to it and then an all-reduce, which
fails. Prints the (process 0, process 1) exit codes over all runs: a
process 1 that is killed by SIGABRT at exit shows -6 where 3 is due, and
its last stderr line. ``--no-exit-hook`` keeps ``initialize`` from
registering ``shutdown`` at exit, to count the aborts without it.
"""

from __future__ import annotations

import argparse
import collections
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main(rank: int, port: int, exit_hook: bool) -> None:
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from change3d_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    if not exit_hook:
        distributed._STATE["exit_hook"] = True  # as if registered: none is
    distributed.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu", timeout=3.0)
    if rank == 1:
        raise SystemExit(3)
    sends = [dist.isend(torch.ones(1 << 16), 1, tag=i) for i in range(32)]  # noqa: F841
    distributed.all_reduce_sum(torch.ones(1))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=192)
    ap.add_argument("--at-once", type=int, default=8, help="pairs of processes at a time")
    ap.add_argument("--no-exit-hook", action="store_true")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.port, not args.no_exit_hook)
        return 0
    codes = collections.Counter()
    for start in range(0, args.runs, args.at_once):
        pairs = []
        for _ in range(min(args.at_once, args.runs - start)):
            port = free_port()
            pairs.append([subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--port", str(port)]
                + (["--no-exit-hook"] if args.no_exit_hook else []),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in (0, 1)])
        for pair in pairs:
            errs = [p.communicate(timeout=120)[1] for p in pair]
            codes[tuple(p.returncode for p in pair)] += 1
            if pair[1].returncode == -6:
                last = [l for l in errs[1].splitlines() if l.strip()][-1:]
                print("process 1 aborted:", *last, flush=True)
    print("exit codes (process 0, process 1): runs", ", ".join(
        f"{k}: {v}" for k, v in sorted(codes.items(), key=lambda kv: -kv[1])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
