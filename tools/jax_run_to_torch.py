#!/usr/bin/env python3
"""Bring a run that the JAX package (``change3d_tpu``) trained into
``change3d_tpu_torch``: read its orbax checkpoint and write the port's run
layout, so that ``python -m change3d_tpu_torch.cli predict / eval / serve /
export --checkpoint RUN`` take it.

    python3 tools/jax_run_to_torch.py --model_task bcd --run JAXRUN --out RUN [--which best]
    python3 tools/jax_run_to_torch.py --model_task scd --run JAXRUN --out RUN --num_class 6
    python3 tools/jax_run_to_torch.py --model_task cc --run JAXRUN --out RUN \\
        --word_map WORDMAP.json [--embed_dim 192 --n_head 8 --n_layer 3]

``JAXRUN`` is the JAX training loop's run directory (``{save_dir}/best``
and ``{save_dir}/ckpt``). ``--which best`` (the default) reads the
metric-gated weights through ``change3d_tpu.inference.
restore_best_variables``; ``latest`` the newest training step's
(``CheckpointManager.restore_latest_variables``, weights only). Either is written as
``RUN/best/model.pt`` (``change3d_tpu_torch/checkpoint/io.py``). A JAX
checkpoint holds ``params`` and ``batch_stats`` only: static int8 ranges
are calibrated where they are used (``--quant_mode static``).

The model flags must be those the run was trained with: ``--num_class``
(SCD 6, BDA 5 by default), ``--in_height`` / ``--in_width`` and, for cc,
the vocabulary (``--word_map`` or ``--vocab_size``) and the decoder's
``--embed_dim``, ``--n_head``, ``--n_layer``. The port's model is loaded
strictly from the converted tree, so a mismatch raises.

This tool sits outside both packages and imports both, as the parity tests
do: it runs where JAX and orbax run (on the host CPU), not on the card's
machine.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_NUM_CLASS = {"bcd": 1, "scd": 6, "bda": 5, "cc": 1}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_task", required=True, choices=sorted(_NUM_CLASS))
    p.add_argument("--run", required=True, help="the JAX run dir (best/, ckpt/)")
    p.add_argument("--out", required=True, help="the port's run dir to write (best/model.pt)")
    p.add_argument("--which", default="best", choices=["best", "latest"])
    p.add_argument("--num_class", type=int, default=None)
    p.add_argument("--in_height", type=int, default=256)
    p.add_argument("--in_width", type=int, default=256)
    p.add_argument("--word_map", default=None, help="(cc) the run's WORDMAP json")
    p.add_argument("--vocab_size", type=int, default=None, help="(cc) without --word_map")
    p.add_argument("--embed_dim", type=int, default=192)
    p.add_argument("--n_head", type=int, default=8)
    p.add_argument("--n_layer", type=int, default=3)
    args = p.parse_args(argv)
    if args.num_class is None:
        args.num_class = _NUM_CLASS[args.model_task]
    if args.model_task == "cc":
        if args.word_map:
            with open(args.word_map) as f:
                args.vocab_size = len(json.load(f))
        if not args.vocab_size:
            p.error("cc needs --word_map or --vocab_size")
    return args


def _model_kw(args) -> dict:
    kw = dict(num_classes=args.num_class, in_height=args.in_height, in_width=args.in_width)
    if args.model_task == "cc":
        kw = dict(in_height=args.in_height, in_width=args.in_width, vocab_size=args.vocab_size,
                  embed_dim=args.embed_dim, num_heads=args.n_head, num_layers=args.n_layer)
    return kw


def build_models(args):
    """(the JAX Change3D, the port's Change3D on the CPU) of the run's
    configuration, X3D-L backbones."""
    from change3d_tpu.models.trainer import Change3D as JaxChange3D, Task as JaxTask
    from change3d_tpu_torch.models.trainer import Change3D, Task

    kw = _model_kw(args)
    return (JaxChange3D(task=JaxTask(args.model_task), **kw),
            Change3D(Task(args.model_task), device="cpu", **kw))


def read_variables(jax_model, run: str, which: str) -> dict:
    """The run's ``{'params', 'batch_stats'}`` as numpy arrays: ``best``
    through ``change3d_tpu.inference.restore_best_variables``, ``latest``
    through ``CheckpointManager.restore_latest_variables``."""
    import jax
    import numpy as np

    from change3d_tpu.checkpoint.orbax_io import CheckpointManager
    from change3d_tpu.inference import restore_best_variables

    run = os.path.abspath(run)  # orbax takes absolute paths
    if which == "best":
        variables = restore_best_variables(jax_model, run)
    else:
        variables, step = CheckpointManager(run).restore_latest_variables()
        print(f"restored step {step}", flush=True)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def convert(args, models=None) -> str:
    """Convert ``args.run`` into ``args.out``; returns the written path."""
    from change3d_tpu_torch.checkpoint.convert import from_jax_variables
    from change3d_tpu_torch.checkpoint.io import CheckpointManager

    jax_model, model = models or build_models(args)
    variables = read_variables(jax_model, args.run, args.which)
    model.load_state_dict(from_jax_variables(variables, model.backbone_cfg), strict=True)
    CheckpointManager(args.out).save_best(model)
    path = os.path.join(args.out, "best", "model.pt")
    n = sum(p.numel() for p in model.parameters())
    print(f"converted {args.which} of {args.run}: {n:,} params -> {path} (use with "
          f"'python -m change3d_tpu_torch.cli predict/eval/serve/export --checkpoint "
          f"{args.out}')", flush=True)
    return path


def main(argv=None) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")  # a host job, as JAX's convert-reference
    convert(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
