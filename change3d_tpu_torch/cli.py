"""Command-line entry point (counterpart of ``change3d_tpu/cli.py``) with
the three detection subcommands:

  python -m change3d_tpu_torch.cli bcd --file_root DATA --save_dir EXP  # LEVIR-CD, batch 16
  python -m change3d_tpu_torch.cli scd --file_root DATA --save_dir EXP  # SECOND, 6 classes, batch 8
  python -m change3d_tpu_torch.cli bda --file_root DATA --save_dir EXP  # xBD, 5 classes, batch 12

Each trains the full-width X3D-L model of its task on the card
(``--device cuda``, the default; ``--device cpu`` runs the plain PyTorch
versions on the host) in bf16 by default, validates from epoch 1 on through
the fused CUDA blocks, checkpoints, and resumes with ``--resume``. The
defaults are the JAX CLI's. Flags of the JAX CLI that are not ported yet are
refused with the reason.
"""

from __future__ import annotations

import argparse
import dataclasses

from change3d_tpu_torch.train.loop import RunConfig, run_detection_training

_NOT_PORTED = {
    "--pretrained": "loading X3D_L.pyth waits on the Kinetics checkpoint being in the repository",
    "--remat": "activation rematerialisation is not ported",
    "--no-remat": "activation rematerialisation is not ported",
    "--packed": "time-packed execution is not ported (the port holds the unpacked path)",
    "--no-packed": "time-packed execution is not ported (the port holds the unpacked path)",
    "--fused": "validation always runs the fused CUDA blocks",
    "--loader": "only the threaded loader is ported",
    "--profile_dir": "use tools/profile_torch_bcd.py --train",
    "--coordinator_address": "multi-GPU training arrives with the multi-GPU slice",
    "--num_processes": "multi-GPU training arrives with the multi-GPU slice",
    "--process_id": "multi-GPU training arrives with the multi-GPU slice",
    "--platform": "use --device {cuda,cpu}",
    "--num_class": "BCD has one sigmoid output",
}
# task -> (dataset, --num_class or None where refused, batch size, max steps)
_TASKS = {
    "bcd": ("LEVIR-CD", None, 16, 80_000),
    "scd": ("SECOND", 6, 8, 80_000),
    "bda": ("xBD", 5, 12, 200_000),
}
_HELP = {"bcd": "binary change detection", "scd": "semantic change detection",
         "bda": "building damage assessment"}


class _NotPorted(argparse.Action):
    def __init__(self, option_strings, dest, **kwargs):
        kwargs.update(nargs="?", default=argparse.SUPPRESS)
        super().__init__(option_strings, dest, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet: {_NOT_PORTED[option_string]}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("change3d_tpu_torch")
    sub = parser.add_subparsers(dest="task", required=True)
    for task, (dataset, num_class, batch_size, max_steps) in _TASKS.items():
        p = sub.add_parser(task, help=_HELP[task])
        p.add_argument("--file_root", required=True, help="dataset root directory")
        p.add_argument("--dataset", default=dataset, help="names the run directory")
        p.add_argument("--in_height", type=int, default=256)
        p.add_argument("--in_width", type=int, default=256)
        p.add_argument("--batch_size", type=int, default=batch_size)
        p.add_argument("--num_workers", type=int, default=4)
        p.add_argument("--lr", type=float, default=2e-4)
        p.add_argument("--lr_mode", default="poly", choices=["poly", "step"])
        p.add_argument("--step_loss", type=int, default=100)
        p.add_argument("--save_dir", default="./exp")
        p.add_argument("--resume", action="store_true")
        p.add_argument("--seed", type=int, default=16)
        p.add_argument("--max_epochs", type=int, default=None)
        p.add_argument("--max_steps", type=int, default=max_steps)
        p.add_argument("--compute_dtype", default="bfloat16", choices=["float32", "bfloat16"])
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="cuda (default; raises without a card) or cpu")
        if num_class is not None:
            p.add_argument("--num_class", dest="num_classes", type=int, default=num_class,
                           help="semantic classes of the class heads")
        for flag in _NOT_PORTED:
            if not (flag == "--num_class" and num_class is not None):
                p.add_argument(flag, action=_NotPorted, help=argparse.SUPPRESS)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    fields = {f.name for f in dataclasses.fields(RunConfig)}
    cfg = RunConfig(**{k: v for k, v in vars(args).items() if k in fields})
    return run_detection_training(cfg)


if __name__ == "__main__":
    main()
