#!/usr/bin/env python3
"""Compare the SASS of the fused block kernels of two trees of this repo.

    python3 tools/sass_diff_fused_block.py OTHER_TREE [TREE]

Builds ``csrc/fused_block.cu`` in both trees (``cuda_build``, each into its
own ``_build/``, both at once), disassembles both libraries with
``cuobjdump -sass`` and, for each kernel of OTHER_TREE (a tree from before
the T-tile: ``fused_block_{f32,bf16}_kernel`` without ``kTTiled``), diffs
its instructions against TREE's instantiation without T-tiles. Addresses
and encodings are dropped, so only instructions, registers and constant
offsets count. Prints per kernel the instruction counts and the number of
differing lines, with the first few of them. Needs the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import difflib
import glob
import os
import re
import subprocess
import sys

CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
BUILD = "from change3d_tpu_torch.ops import cuda_build; cuda_build.build(['fused_block'])"


def kernels(so: str) -> dict:
    """{kernel name after 'fused_block_' (mangled template arguments): SASS lines}."""
    out = subprocess.run([CUOBJDUMP, "-sass", so], capture_output=True, text=True,
                         check=True).stdout
    res, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1).split("fused_block_")[-1].split("EvNS")[0]
            res[name] = []
            continue
        if name:
            ins = re.sub(r"/\*.*?\*/", "", line).strip()
            if ins:
                res[name].append(ins)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other")
    ap.add_argument("tree", nargs="?", default=".")
    args = ap.parse_args()
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=t) for t in (args.other, args.tree)]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("sass_diff_fused_block: a build failed")
    lib = lambda t: glob.glob(os.path.join(t, "change3d_tpu_torch", "_build", "fused_block-*.so"))[0]
    old, new = kernels(lib(args.other)), kernels(lib(args.tree))
    for k in sorted(old):
        untiled = k[:-2] + "ELb0EE"  # the same template arguments, kTTiled = false
        d = [l for l in difflib.unified_diff(old[k], new[untiled], lineterm="", n=0)
             if not l.startswith(("---", "+++", "@@"))]
        print(f"sass {k} vs {untiled}: instructions {len(old[k])} {len(new[untiled])}, "
              f"differing lines {len(d)}")
        for l in d[:6]:
            print("   ", l)
    return 0


if __name__ == "__main__":
    sys.exit(main())
