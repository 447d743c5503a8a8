#!/usr/bin/env python3
"""Which int8 products ``torch._int_mm`` (cuBLASLt) takes on this card.

    python3 tools/probe_int_mm.py [--out chiprun_out/probe_int_mm.json]

For row counts M (small, odd, multiples of 32, and X3D-L's at batch 8 on
T = 3: 98,304 and 393,216), reduction widths K and output widths N around
X3D-L's (24, 48, 96, 192 and the inner 54 / 108 / 216 / 432, padded to
multiples of 8), and the kernel row-major [K, N] or column-major (a
transposed [N, K]), it runs one product of random int8 operands and
compares it with the fp64 product (exact: integer sums below 2^53). Prints,
per layout and M, the (K, N) that are refused or wrong, and the card's name
and power limit. ``ops/quant.py`` pads to what this finds taken (row-major
kernel, rows a multiple of 32).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess

import torch

ROWS = (17, 24, 96, 113, 120, 1536, 1540, 98304, 98308, 393216)
KS = (24, 48, 56, 96, 112, 216, 432)
NS = (24, 48, 56, 96, 112, 192, 216, 432)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "probe_int_mm.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_int_mm: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} ({card})")
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {}
    for m, k, n, layout in itertools.product(ROWS, KS, NS, ("row", "col")):
        x = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        if layout == "row":
            w = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        else:
            w = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8).t()
        try:
            y = torch._int_mm(x, w)
            ok = torch.equal(y.double(), x.double() @ w.double())
            result[f"{layout} {m} {k} {n}"] = "ok" if ok else "wrong"
        except RuntimeError:
            result[f"{layout} {m} {k} {n}"] = "refused"
    for layout in ("row", "col"):
        for m in ROWS:
            bad = [(k, n, result[f"{layout} {m} {k} {n}"]) for k in KS for n in NS
                   if result[f"{layout} {m} {k} {n}"] != "ok"]
            print(f"{layout}-major kernel, M={m}: {len(bad)} of {len(KS) * len(NS)} not ok "
                  f"{bad}")
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "result": result}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
