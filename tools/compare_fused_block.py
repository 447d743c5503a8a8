#!/usr/bin/env python3
"""Time the fused block kernels of two or more trees of this repo on one card.

    python3 tools/compare_fused_block.py --trees _tree/parent . [--rounds 2]
        [--batch 8] [--iters 20] [--out chiprun_out/compare_fused_block.json]

Each tree's ``change3d_tpu_torch`` runs in a process of its own (it builds
its own kernels into its own ``_build/``), in the order A B B A per round,
so that drift of the card's clock over the call falls on both alike. A
process times ``fused_block_fwd`` and ``fused_block_se_sums`` on bf16
operands (``chip_smoke.operands``, one seed for all trees) at the stage
shapes of the Change3D clips (T = 3, 4, 5 at ``--batch``) and of the CC
encoder (T = 3 at batch 32), and sums them over one forward with
``chip_smoke.py``'s launch counts. Prints each run, then per tree and
clip the median and least ms per forward, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_tree(tree: str, batch: int, iters: int) -> dict:
    """One process's rows: {"T<t>_B<b>": {kernel: ms per forward}, ...}."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from change3d_tpu_torch.ops import fused_block as fb

    cs = load_smoke()
    dev = torch.device("cuda")
    out = {}
    for t, b in [(t, batch) for t in cs.CLIPS] + [(3, cs.CC_BATCH)]:
        rs = np.random.RandomState(1000 * t + b)
        key = f"T{t}_B{b}"
        out[key] = {"fused_block_fwd": 0.0, "fused_block_se_sums": 0.0, "rows": {}}
        for name, hw, c, ci, cr, n_fwd, n_sums in cs.STAGES:
            if b == cs.CC_BATCH:
                n_fwd, n_sums = cs.CC_LAUNCHES[name]
            if n_fwd == 0:
                continue
            ops, se = cs.operands(rs, b, t, hw, c, ci, cr, torch.bfloat16, dev, True)
            gate = fb.se_gate(fb.se_sums_reference(*ops[:7]).sum(1) / (t * hw * hw), *se)
            fwd = cs.event_ms(lambda: fb.fused_block_fwd(*ops, gate), iters)
            sums = cs.event_ms(lambda: fb.fused_block_se_sums(*ops[:7]), iters)
            out[key]["rows"][name] = {"fused_block_fwd": fwd, "fused_block_se_sums": sums}
            out[key]["fused_block_fwd"] += fwd * n_fwd
            out[key]["fused_block_se_sums"] += sums * n_sums
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=None, help="repo trees to compare")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "compare_fused_block.json"))
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_fused_block: needs an NVIDIA GPU")
    if args.child is not None:
        print(json.dumps(time_tree(args.child, args.batch, args.iters)), flush=True)
        return 0
    trees = args.trees or [REPO]
    card = load_smoke().card_line()
    order = []
    for _ in range(args.rounds):
        order += trees + trees[::-1]
    runs = []
    for tree in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                              "--batch", str(args.batch), "--iters", str(args.iters)],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            sys.stderr.write(res.stdout + res.stderr)
            raise SystemExit(f"compare_fused_block: {tree} failed ({res.returncode})")
        rows = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"tree": tree, "rows": rows})
        print(f"run {len(runs)} {tree} ({card}): " + json.dumps(
            {k: [v["fused_block_fwd"], v["fused_block_se_sums"]] for k, v in rows.items()}),
            flush=True)
    summary = {}
    for tree in trees:
        mine = [r["rows"] for r in runs if r["tree"] == tree]
        summary[tree] = {
            key: {kernel: {"median_ms": statistics.median(r[key][kernel] for r in mine),
                           "min_ms": min(r[key][kernel] for r in mine)}
                  for kernel in ("fused_block_fwd", "fused_block_se_sums")}
            for key in mine[0]}
    for tree, keys in summary.items():
        for key, kernels in keys.items():
            print(f"per forward {tree} {key} ({card}): " + ", ".join(
                f"{k} median {v['median_ms']} min {v['min_ms']} ms" for k, v in kernels.items()))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "order": order, "runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
