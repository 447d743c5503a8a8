"""Command-line entry point (counterpart of ``change3d_tpu/cli.py``) with
the four training subcommands:

  python -m change3d_tpu_torch.cli bcd --file_root DATA --save_dir EXP  # LEVIR-CD, batch 16
  python -m change3d_tpu_torch.cli scd --file_root DATA --save_dir EXP  # SECOND, 6 classes, batch 8
  python -m change3d_tpu_torch.cli bda --file_root DATA --save_dir EXP  # xBD, 5 classes, batch 12
  python -m change3d_tpu_torch.cli cc  --file_root DATA --save_dir EXP  # LEVIR-CC, batch 32, fp32

Each trains the full-width X3D-L model of its task on the card
(``--device cuda``, the default; ``--device cpu`` runs the plain PyTorch
versions on the host), evaluates through the fused CUDA blocks (detection
from epoch 1 on, in bf16 by default; CC after every epoch with beam search),
checkpoints, and resumes with ``--resume``. The defaults are the JAX CLI's.
Flags of the JAX CLI that are not ported yet are refused with the reason.
"""

from __future__ import annotations

import argparse
import dataclasses

from change3d_tpu_torch.train.caption_loop import CaptionRunConfig, run_caption_training
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
_CC_IGNORED = "the JAX CLI accepts it for cc and ignores it; drop the flag"
_CC_NOT_PORTED = {
    "--pretrained": _NOT_PORTED["--pretrained"],
    "--remat": "not needed: CC training at the defaults peaks well inside the card's memory "
               "(PERF.md)",
    "--no-remat": "activation rematerialisation is not ported",
    "--loader": "only the threaded loader is ported (the grain loader is not)",
    "--coordinator_address": "multi-GPU CC training, with its allgathered evaluation, arrives "
                             "with the multi-GPU slice",
    "--num_processes": "multi-GPU CC training arrives with the multi-GPU slice",
    "--process_id": "multi-GPU CC training arrives with the multi-GPU slice",
    "--profile_dir": "use tools/profile_torch_bcd.py --task cc",
    "--platform": _NOT_PORTED["--platform"],
    "--packed": _NOT_PORTED["--packed"],
    "--no-packed": _NOT_PORTED["--no-packed"],
    "--fused": "evaluation always runs the fused CUDA blocks",
    "--in_height": _CC_IGNORED,
    "--in_width": _CC_IGNORED,
    "--lr_mode": _CC_IGNORED,
    "--step_loss": _CC_IGNORED,
    "--max_epochs": "use --epochs",
}


class _NotPorted(argparse.Action):
    def __init__(self, option_strings, dest, reason: str, **kwargs):
        kwargs.update(nargs="?", default=argparse.SUPPRESS)
        super().__init__(option_strings, dest, **kwargs)
        self.reason = reason

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet: {self.reason}")


def _add_cc(sub) -> None:
    """``cc``: the JAX CLI's flags and defaults (batch 32, lr 1e-4, fp32)."""
    p = sub.add_parser("cc", help="change captioning")
    p.add_argument("--file_root", required=True, help="dataset root directory")
    p.add_argument("--dataset", default=CaptionRunConfig.dataset)
    p.add_argument("--word_map", default=None,
                   help="WORDMAP json (default: <root>/WORDMAP_<dataset>.json)")
    p.add_argument("--save_dir", default="./exp")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--eval_batch_size", type=int, default=32)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4, help="the decoder's learning rate")
    p.add_argument("--encoder_lr", type=float, default=None,
                   help="a separate encoder learning rate (default: --lr)")
    p.add_argument("--fine_tune_encoder", action=argparse.BooleanOptionalAction, default=True,
                   help="--no-fine_tune_encoder freezes the encoder")
    p.add_argument("--embed_dim", type=int, default=192)
    p.add_argument("--n_head", type=int, default=8)
    p.add_argument("--n_layer", type=int, default=3)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--grad_clip", type=float, default=5.0)
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--seed", type=int, default=16)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) or cpu")
    for flag, reason in _CC_NOT_PORTED.items():
        p.add_argument(flag, action=_NotPorted, reason=reason, help=argparse.SUPPRESS)


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
        for flag, reason in _NOT_PORTED.items():
            if not (flag == "--num_class" and num_class is not None):
                p.add_argument(flag, action=_NotPorted, reason=reason, help=argparse.SUPPRESS)
    _add_cc(sub)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    config, run = ((CaptionRunConfig, run_caption_training) if args.task == "cc"
                   else (RunConfig, run_detection_training))
    fields = {f.name for f in dataclasses.fields(config)}
    return run(config(**{k: v for k, v in vars(args).items() if k in fields}))


if __name__ == "__main__":
    main()
