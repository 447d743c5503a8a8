"""Command-line entry point (counterpart of ``change3d_tpu/cli.py``).

Training (each trains the full-width X3D-L model of its task and evaluates
through the fused CUDA blocks; ``--pretrained X3D_L.pyth`` starts the
backbone from Kinetics; ``--resume`` resumes):

  python -m change3d_tpu_torch.cli bcd --file_root DATA --save_dir EXP  # LEVIR-CD, batch 16
  python -m change3d_tpu_torch.cli scd --file_root DATA --save_dir EXP  # SECOND, 6 classes, batch 8
  python -m change3d_tpu_torch.cli bda --file_root DATA --save_dir EXP  # xBD, 5 classes, batch 12
  python -m change3d_tpu_torch.cli cc  --file_root DATA --save_dir EXP  # LEVIR-CC, batch 32, fp32

``--loader grain`` feeds them through worker processes (the JAX CLI's
flag; on the port the torch worker-process loader, not the grain package);
``--profile_dir DIR`` traces training steps 10-14 with torch.profiler
(``serve --profile_dir DIR``: served batches 10-14 after the warm-up);
``--remat`` recomputes the backbone's block pairs in the backward (off by
default, unlike the JAX CLI: the card holds the default steps without it).

Multi-GPU training, one process per card (N commands, i = 0 .. N-1; on the
CPU add ``--device cpu`` and the processes use gloo)::

  python -m change3d_tpu_torch.cli bcd --file_root DATA --save_dir EXP \
      --coordinator_address 127.0.0.1:29500 --num_processes N --process_id i

``--batch_size`` is the global batch (rounded up to a multiple of N); every
process shares one ``--save_dir``. ``predict`` and ``serve`` take
``--shard`` to spread each batch over every local card in one process.

Using a saved run (a run dir holding ``best/model.pt``, from training or
from ``convert-reference``):

  python -m change3d_tpu_torch.cli predict --model_task bcd --checkpoint RUN --file_root DATA --out OUT [--tiled]
  python -m change3d_tpu_torch.cli eval    --model_task bcd --checkpoint RUN --file_root DATA [--which latest]
  python -m change3d_tpu_torch.cli serve   --model_task bcd --checkpoint RUN [--port 8000]
  python -m change3d_tpu_torch.cli export  --model_task bcd --checkpoint RUN --out bcd.pt2 [--batch 8]
  python -m change3d_tpu_torch.cli serve   --model_task bcd --artifact bcd.pt2
  python -m change3d_tpu_torch.cli info    --model_task bcd
  python -m change3d_tpu_torch.cli predict --model_task bcd ... --quantized [--quant_mode static]
  python -m change3d_tpu_torch.cli convert-reference --model_task bcd --torch_checkpoint best_model.pth --out RUN
  python -m change3d_tpu_torch.cli verify-checkpoint --pretrained X3D_L.pyth [--trace ref_acts.npz]

Kinetics-400 video classification with X3D-L (the ``X3D_L.pyth`` network,
or weights drawn from ``--seed``) of uint8 [N, T, H, W, 3] clips (16 x 312^2
as published), N = videos x ``--views``; top-5 classes per video to JSON:

  python -m change3d_tpu_torch.cli classify --clips clips.npy --out top5.json [--pretrained X3D_L.pyth] [--views 30]

Every subcommand runs on the card (``--device cuda``, the default; it
raises without one) unless given ``--device cpu``, which runs the plain
PyTorch versions on the host; nothing falls back from one to the other. The
defaults are the JAX CLI's (but ``--remat``). ``predict``, ``eval`` and
``export`` take ``--quantized`` (int8 pointwise convs, fusion off) with
``--quant_mode dynamic`` or ``static`` (ranges calibrated on
``--calib_batches`` train batches; cc takes dynamic only), ``serve`` takes
``--quantized``. Flags of the JAX CLI that belong to later slices are
refused with the reason.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from change3d_tpu_torch.train.caption_loop import CaptionRunConfig, run_caption_training
from change3d_tpu_torch.train.loop import RunConfig, run_detection_training

_PACKED = "time-packed execution is never ported (the port holds the unpacked path)"
_FUSED_HELP = "accepted and without effect: evaluation always runs the fused CUDA blocks"
_NOT_PORTED = {
    "--packed": _PACKED,
    "--no-packed": _PACKED,
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
_NUM_CLASS = {"bcd": 1, "scd": 6, "bda": 5, "cc": 1}
_CC_IGNORED = "the JAX CLI accepts it for cc and ignores it; drop the flag"
_CC_NOT_PORTED = {
    "--platform": _NOT_PORTED["--platform"],
    "--packed": _PACKED,
    "--no-packed": _PACKED,
    "--in_height": _CC_IGNORED,
    "--in_width": _CC_IGNORED,
    "--lr_mode": _CC_IGNORED,
    "--step_loss": _CC_IGNORED,
    "--max_epochs": "use --epochs",
}
# Flags of the JAX CLI's other subcommands that belong to later slices.
_USE_NOT_PORTED = {
    "--packed": _PACKED,
    "--no-packed": _PACKED,
    "--platform": _NOT_PORTED["--platform"],
}
_EXPORT_NOT_PORTED = {
    "--platforms": "use --device; load_exported(device=...) moves an artifact",
    "--platform": "use --device; load_exported(device=...) moves an artifact",
}
_PROFILE_HELP = "write a torch.profiler trace of training steps 10-14 here"
_SERVE_PROFILE_HELP = ("write a torch.profiler trace of served batches 10-14 (counted after "
                       "the warm-up), every thread, here")
_CC_STATIC = {"predict": "cc predict supports dynamic int8 only",
              "eval": "cc eval supports dynamic int8 only (static calibration is wired for the "
                      "detection tasks)"}


class _NotPorted(argparse.Action):
    def __init__(self, option_strings, dest, reason: str, **kwargs):
        kwargs.update(nargs="?", default=argparse.SUPPRESS)
        super().__init__(option_strings, dest, **kwargs)
        self.reason = reason

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet: {self.reason}")


def _refuse(p, flags) -> None:
    for flag, reason in flags.items():
        p.add_argument(flag, action=_NotPorted, reason=reason, help=argparse.SUPPRESS)


def _loader(p) -> None:
    p.add_argument("--loader", default="threaded", choices=["threaded", "grain"],
                   help="input pipeline: 'threaded' (worker threads, the default) or 'grain', "
                        "which on the port is the torch worker-process loader "
                        "(data/process_pipeline.py; the grain package itself imports jax)")


def _device(p) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) or cpu")


def _processes(p) -> None:
    """The JAX CLI's multi-process flags (training subcommands)."""
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of process 0 for a multi-process run (one process per "
                        "card: NCCL on cuda, gloo on cpu); single-process runs leave it unset")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


def _shard(p) -> None:
    p.add_argument("--shard", action="store_true",
                   help="spread each batch over every local card, one model replica per card "
                        "(the batch size must be a multiple of the card count)")


def _quant(p, calibrates: bool = True) -> None:
    """The JAX CLI's int8 flags (predict, eval, export; serve: --quantized)."""
    p.add_argument("--quantized", action="store_true",
                   help="int8 pointwise convs at eval (serving-grade approximate numerics; the "
                        "fused blocks then stay off)")
    if calibrates:
        p.add_argument("--quant_mode", default="dynamic", choices=["dynamic", "static"],
                       help="int8 activation scales: per sample on the fly, or ranges "
                            "calibrated on train-split batches (detection tasks)")
        p.add_argument("--calib_batches", type=int, default=8,
                       help="train batches that calibrate --quant_mode static")


def _cc_model_flags(p) -> None:
    """The CC decoder's width and the word map (predict, eval, serve)."""
    p.add_argument("--dataset", default=CaptionRunConfig.dataset)
    p.add_argument("--word_map", default=None,
                   help="WORDMAP json (default: <file_root>/WORDMAP_<dataset>.json)")
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--embed_dim", type=int, default=192)
    p.add_argument("--n_head", type=int, default=8)
    p.add_argument("--n_layer", type=int, default=3)


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
    p.add_argument("--pretrained", default=None, help="a Kinetics X3D_L.pyth for the backbone")
    p.add_argument("--fused", action="store_true", help=_FUSED_HELP)
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--profile_dir", default=None, help=_PROFILE_HELP)
    p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=False,
                   help="accepted and without effect, as in the JAX CLI (its caption loop "
                        "never reads it)")
    _loader(p)
    _device(p)
    _processes(p)
    _refuse(p, _CC_NOT_PORTED)


def _add_train(sub) -> None:
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
        p.add_argument("--pretrained", default=None, help="a Kinetics X3D_L.pyth for the backbone")
        p.add_argument("--fused", action="store_true", help=_FUSED_HELP)
        p.add_argument("--seed", type=int, default=16)
        p.add_argument("--max_epochs", type=int, default=None)
        p.add_argument("--max_steps", type=int, default=max_steps)
        p.add_argument("--compute_dtype", default="bfloat16", choices=["float32", "bfloat16"])
        p.add_argument("--profile_dir", default=None, help=_PROFILE_HELP)
        p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=False,
                       help="recompute the backbone's block pairs in the backward (less "
                            "memory, one more forward of them; off by default, unlike the JAX "
                            "CLI, whose default-on was sized for a TPU's memory)")
        _loader(p)
        _device(p)
        _processes(p)
        if num_class is not None:
            p.add_argument("--num_class", dest="num_classes", type=int, default=num_class,
                           help="semantic classes of the class heads")
        _refuse(p, {f: r for f, r in _NOT_PORTED.items()
                    if not (f == "--num_class" and num_class is not None)})


def _add_use(sub) -> None:
    """predict, eval, serve, info, convert-reference, verify-checkpoint, classify."""
    tasks = ["bcd", "scd", "bda", "cc"]
    p = sub.add_parser("predict", help="write masks (bcd/scd/bda) or captions.json (cc) for a "
                                       "split of a dataset")
    p.add_argument("--model_task", required=True, choices=tasks)
    p.add_argument("--checkpoint", required=True, help="run dir holding best/model.pt")
    p.add_argument("--file_root", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--num_class", type=int, default=None)
    p.add_argument("--in_height", type=int, default=256)
    p.add_argument("--in_width", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--tiled", action="store_true",
                   help="native-size scenes: slide the model's window over them and blend "
                        "the overlaps (detection tasks)")
    p.add_argument("--tile_overlap", type=int, default=32)
    _quant(p)
    _cc_model_flags(p)
    _device(p)
    _shard(p)
    _refuse(p, _USE_NOT_PORTED)

    p = sub.add_parser("eval", help="score a saved run (best or latest weights) on a split")
    p.add_argument("--model_task", required=True, choices=tasks)
    p.add_argument("--checkpoint", required=True, help="run dir holding best/ and ckpt/")
    p.add_argument("--file_root", required=True)
    p.add_argument("--split", default=None, help="dataset split (default: test; CC: TEST)")
    p.add_argument("--which", default="best", choices=["best", "latest"])
    p.add_argument("--num_class", type=int, default=None)
    p.add_argument("--in_height", type=int, default=256)
    p.add_argument("--in_width", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="detection activations (CC evaluates in fp32)")
    p.add_argument("--fused", action="store_true", help=_FUSED_HELP)
    p.add_argument("--json", action="store_true", help="print the scores as JSON")
    p.add_argument("--save_json", action="store_true",
                   help="CC: also write res.json / gts.json into the run dir")
    _quant(p)
    _cc_model_flags(p)
    _device(p)
    _refuse(p, _USE_NOT_PORTED)

    p = sub.add_parser("serve", help="HTTP batching prediction service for a saved run or an "
                                     "exported artifact (POST /v1/predict, GET /healthz, "
                                     "GET /metrics)")
    p.add_argument("--model_task", required=True, choices=tasks)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", help="run dir holding best/model.pt")
    src.add_argument("--artifact", help="an exported artifact (cli export)")
    p.add_argument("--file_root", default=None, help="(cc) dataset root for the word map")
    p.add_argument("--num_class", type=int, default=None)
    p.add_argument("--in_height", type=int, default=256)
    p.add_argument("--in_width", type=int, default=256)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--batch_size", type=int, default=16,
                   help="largest batch: requests gather up to it, padded to the smallest "
                        "bucket that holds them")
    p.add_argument("--buckets", default=None,
                   help="comma-separated bucket sizes, the largest --batch_size (default: "
                        "1/4, 1/2, 1 of it for detection, one bucket for cc and --tiled)")
    p.add_argument("--max_delay_ms", type=float, default=10.0,
                   help="longest wait for more requests after the first")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--tiled", action="store_true", help="serve native-size scenes, one at a time")
    p.add_argument("--tile_overlap", type=int, default=32)
    p.add_argument("--no_warmup", action="store_true",
                   help="skip running every bucket at start-up (the first request then "
                        "builds the kernels)")
    p.add_argument("--profile_dir", default=None, help=_SERVE_PROFILE_HELP)
    p.add_argument("--fused", action="store_true", help=_FUSED_HELP)
    _quant(p, calibrates=False)
    _cc_model_flags(p)
    _device(p)
    _shard(p)
    _refuse(p, _USE_NOT_PORTED)

    p = sub.add_parser("info", help="parameter counts and FLOPs of a task model, beside the "
                                    "reference's published numbers")
    p.add_argument("--model_task", required=True, choices=tasks)
    p.add_argument("--num_class", type=int, default=None)
    p.add_argument("--in_height", type=int, default=256)
    p.add_argument("--in_width", type=int, default=256)
    p.add_argument("--vocab_size", type=int, default=500)
    p.add_argument("--embed_dim", type=int, default=192)
    p.add_argument("--n_head", type=int, default=8)
    p.add_argument("--n_layer", type=int, default=3)
    p.add_argument("--json", action="store_true", help="print the report as JSON")
    _device(p)
    _refuse(p, {"--platform": _NOT_PORTED["--platform"]})

    p = sub.add_parser("convert-reference",
                       help="turn a model trained with the reference (best_model.pth or "
                            "checkpoint.pth.tar) into a run dir that predict / eval / serve read")
    p.add_argument("--model_task", required=True, choices=tasks)
    p.add_argument("--torch_checkpoint", required=True)
    p.add_argument("--out", required=True, help="run dir to create ({out}/best/model.pt)")
    p.add_argument("--num_class", type=int, default=None,
                   help="read from the checkpoint when omitted")
    p.add_argument("--in_height", type=int, default=256)
    p.add_argument("--in_width", type=int, default=256)
    p.add_argument("--n_head", type=int, default=8, help="CC only; the weights do not tell it")
    _device(p)

    p = sub.add_parser("verify-checkpoint",
                       help="strictly convert an X3D_L.pyth, run it block by block on a fixed "
                            "probe and (with --trace) compare with a recorded torch trace")
    p.add_argument("--pretrained", required=True, help="path to X3D_L.pyth")
    p.add_argument("--trace", default=None, help="ref_acts.npz from tools/record_torch_trace.py")
    p.add_argument("--report", default=None, help="write the report as JSON here")
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rtol", type=float, default=None)
    p.add_argument("--atol", type=float, default=None)
    _device(p)
    _refuse(p, {"--platform": _NOT_PORTED["--platform"]})

    p = sub.add_parser("classify",
                       help="Kinetics-400 top-5 classes of videos with X3D-L (ClipClassifier): "
                            "each video's softmax averaged over its views")
    p.add_argument("--clips", required=True,
                   help=".npy of uint8 [N, T, H, W, 3] clips (16 x 312^2 as published), each "
                        "video's --views clips in a row")
    p.add_argument("--out", required=True, help="JSON file of each video's top-5 classes")
    p.add_argument("--views", type=int, default=30,
                   help="clips a video (the published test: 10 temporal x 3 spatial)")
    p.add_argument("--pretrained", default=None,
                   help="X3D_L.pyth (Kinetics-400); default: weights drawn from --seed")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["float32", "bfloat16"])
    _device(p)

    p = sub.add_parser("export", help="export a saved run to a torch.export artifact (.pt2; "
                                      "weights inside, symbolic batch; served by serve "
                                      "--artifact or export.load_exported). For cc the "
                                      "artifact holds the encoder and the beam search")
    p.add_argument("--model_task", required=True, choices=tasks)
    p.add_argument("--checkpoint", required=True, help="run dir holding best/model.pt")
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--num_class", type=int, default=None)
    p.add_argument("--in_height", type=int, default=256)
    p.add_argument("--in_width", type=int, default=256)
    p.add_argument("--batch", type=int, default=None,
                   help="pin the batch (default: symbolic, any batch)")
    p.add_argument("--file_root", default=None,
                   help="dataset root: (cc) for the word map, (--quant_mode static) for the "
                        "train batches that calibrate")
    _quant(p)
    p.add_argument("--calib_batch_size", type=int, default=8)
    _cc_model_flags(p)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device to export on (cuda, the default, raises without a card); "
                        "the loaders move an artifact to theirs")
    _refuse(p, _EXPORT_NOT_PORTED)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("change3d_tpu_torch")
    sub = parser.add_subparsers(dest="task", required=True)
    _add_train(sub)
    _add_cc(sub)
    _add_use(sub)
    return parser


def _num_class(args) -> int:
    return args.num_class if args.num_class is not None else _NUM_CLASS[args.model_task]


def _detection_config(args, **kw) -> RunConfig:
    """The RunConfig of a detection subcommand, with its int8 flags."""
    return RunConfig(task=args.model_task, num_classes=_num_class(args),
                     in_height=args.in_height, in_width=args.in_width, device=args.device,
                     quantized=getattr(args, "quantized", False),
                     quant_mode=getattr(args, "quant_mode", "dynamic"),
                     calib_batches=getattr(args, "calib_batches", 8), **kw)


def _detection_model(args, cfg: RunConfig):
    """``cfg``'s model with the run's best weights; a static int8 model is
    calibrated on ``cfg``'s train split."""
    from change3d_tpu_torch.checkpoint.io import restore_best_state
    from change3d_tpu_torch.train.loop import build_model, calibrate_from_train_split

    model = build_model(cfg)
    model.load_state_dict(restore_best_state(args.checkpoint))
    if cfg.quantized and cfg.quant_mode == "static":
        calibrate_from_train_split(cfg, model)
    return model


def _cc_backbone(args):
    """CC's backbone config: X3D-L, int8 with --quantized (dynamic only)."""
    from change3d_tpu_torch.models.x3d import x3d_l_config

    if not getattr(args, "quantized", False):
        return None
    if getattr(args, "quant_mode", "dynamic") == "static":
        raise SystemExit(_CC_STATIC[args.task])
    return x3d_l_config(quantized_eval=True)


def _caption_config(args, **kw) -> CaptionRunConfig:
    return CaptionRunConfig(file_root=args.file_root or "",
                            dataset=args.dataset, word_map=args.word_map,
                            embed_dim=args.embed_dim, n_head=args.n_head, n_layer=args.n_layer,
                            beam_size=args.beam_size, device=args.device, **kw)


def _compute_dtype(args):
    import torch

    return torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32


def run_predict(args) -> int:
    """Masks (PNG) for every pair of a split; ``--tiled`` takes the scenes
    at native size through ``TiledPredictor``. File names as the JAX CLI
    writes them: BCD ``{name}.png``; SCD ``{name}_{pre,post,change}.png``;
    BDA ``{name}_{loc,cls}.png``."""
    import numpy as np

    from change3d_tpu_torch.data.datasets import DATASETS
    from change3d_tpu_torch.data.pipeline import DataLoader, pair_collate
    from change3d_tpu_torch.data.png import write_png
    from change3d_tpu_torch.data.transforms import eval_normalize, make_transform_pipelines
    from change3d_tpu_torch.inference import Predictor, TiledPredictor
    from change3d_tpu_torch.serving import masks_to_arrays

    task = args.model_task
    cfg = _detection_config(args, file_root=args.file_root, batch_size=args.batch_size)
    predictor = Predictor(_detection_model(args, cfg), compute_dtype=_compute_dtype(args),
                          device=args.device, shard=args.shard)
    os.makedirs(args.out, exist_ok=True)
    suffixes = {"bcd": {"change": ""}, "scd": {"pre": "_pre", "post": "_post",
                                               "change": "_change"},
                "bda": {"loc": "_loc", "cls": "_cls"}}[task]

    def write_one(name: str, out) -> None:
        for key, arr in masks_to_arrays(task, out).items():
            write_png(os.path.join(args.out, f"{name}{suffixes[key]}.png"), arr)

    if args.tiled:
        ds = DATASETS[task](args.file_root, args.split, None)  # native scene sizes
        tiled = TiledPredictor(predictor, overlap=args.tile_overlap, batch_size=args.batch_size)
        for idx, path in enumerate(ds.pre_images):
            img, _ = ds[idx]
            img = eval_normalize(img)  # the eval transform without its resize
            write_one(os.path.splitext(os.path.basename(path))[0],
                      tiled.predict_scene(img[..., :3], img[..., 3:]))
        print(f"wrote {len(ds)} scene predictions to {args.out}", flush=True)
        return 0

    _, eval_tf = make_transform_pipelines(task, args.in_width, args.in_height)
    ds = DATASETS[task](args.file_root, args.split, eval_tf)
    names = [os.path.splitext(os.path.basename(p))[0] for p in ds.pre_images]
    loader = DataLoader(ds, args.batch_size, num_workers=2, collate=pair_collate, pad_final=True)
    idx = 0
    for batch in loader:
        valid = batch.pop("valid")
        out = predictor.predict(batch["pre"], batch["post"])
        for i in np.flatnonzero(valid):
            write_one(names[idx], {k: v[i] for k, v in out.items()})
            idx += 1
    print(f"wrote {idx} predictions to {args.out}", flush=True)
    return 0


def run_predict_captions(args) -> int:
    """Captions for every image of a caption split into ``captions.json``
    ([{"image_id", "caption"}], one row per image)."""
    import numpy as np

    from change3d_tpu_torch.data.datasets import CaptionDataset
    from change3d_tpu_torch.data.pipeline import DataLoader, caption_collate
    from change3d_tpu_torch.inference import CaptionPredictor
    from change3d_tpu_torch.train.caption_loop import (
        _EveryFifth,
        build_caption_model,
        load_word_map,
    )

    backbone = _cc_backbone(args)
    cfg = _caption_config(args)
    word_map = load_word_map(cfg)
    ds = _EveryFifth(CaptionDataset(args.file_root, args.dataset, args.split.upper()))
    model = build_caption_model(cfg, len(word_map), in_size=ds.__getitem__(0)["pre"].shape[0],
                                backbone_cfg=backbone)
    predictor = CaptionPredictor.from_checkpoint(
        model, args.checkpoint, word_map=word_map, beam_size=args.beam_size,
        compute_dtype=_compute_dtype(args), device=args.device, shard=args.shard)
    loader = DataLoader(ds, args.batch_size, num_workers=2, collate=caption_collate,
                        pad_final=True)
    captions = []
    for batch in loader:
        valid = batch.pop("valid", np.ones(len(batch["pre"]), bool))
        texts = predictor.caption(batch["pre"], batch["post"])
        captions += [{"image_id": len(captions) + j, "caption": t}
                     for j, t in enumerate(t for t, v in zip(texts, valid) if v)]
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "captions.json")
    with open(path, "w") as f:
        json.dump(captions, f, indent=1)
    print(f"wrote {len(captions)} captions to {path}", flush=True)
    return 0


def run_eval(args) -> int:
    if args.model_task == "cc":
        from change3d_tpu_torch.train.caption_loop import run_caption_eval

        backbone = _cc_backbone(args)
        cfg = _caption_config(args, eval_batch_size=args.batch_size,
                              num_workers=args.num_workers)
        scores = run_caption_eval(cfg, run_dir=args.checkpoint, split=args.split,
                                  which=args.which, save_json=args.save_json,
                                  backbone_cfg=backbone)
    else:
        from change3d_tpu_torch.train.loop import run_detection_eval

        cfg = _detection_config(args, file_root=args.file_root, batch_size=args.batch_size,
                                num_workers=args.num_workers, compute_dtype=args.compute_dtype)
        scores = run_detection_eval(cfg, run_dir=args.checkpoint, split=args.split or "test",
                                    which=args.which)
    if args.json:
        print(json.dumps(scores), flush=True)
    else:
        for k, v in scores.items():
            print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}", flush=True)
    return 0


def _cc_word_map(args):
    """CC's run config and word map (export, serve)."""
    from change3d_tpu_torch.train.caption_loop import load_word_map

    if not (args.file_root or args.word_map):
        raise SystemExit(f"cc {args.task} needs --word_map (or --file_root to find it)")
    cfg = _caption_config(args)
    return cfg, load_word_map(cfg)


def _cc_model(args, cfg, word_map, backbone_cfg=None):
    """The CC model of ``args``' geometry (square inputs only)."""
    from change3d_tpu_torch.train.caption_loop import build_caption_model

    if args.in_width != args.in_height:
        raise SystemExit(f"cc {args.task}: the caption model is square "
                         "(--in_height = --in_width)")
    return build_caption_model(cfg, len(word_map), in_size=args.in_height,
                               backbone_cfg=backbone_cfg)


def run_export(args) -> int:
    """A saved run -> one artifact (``export.py``), exported on --device;
    ``--quantized --quant_mode static`` calibrates on ``--calib_batches``
    train batches of ``--calib_batch_size`` and bakes the ranges in."""
    from change3d_tpu_torch.checkpoint.io import restore_best_state
    from change3d_tpu_torch.export import export_caption_model, export_model

    if args.model_task == "cc":
        if args.quantized:
            raise SystemExit("cc export: --quantized applies to the detection tasks (the JAX "
                             "CLI ignores it for cc)")
        cfg, word_map = _cc_word_map(args)
        model = _cc_model(args, cfg, word_map)
        model.load_state_dict(restore_best_state(args.checkpoint))
        blob = export_caption_model(model, word_map, args.out, beam_size=args.beam_size,
                                    batch=args.batch)
    else:
        if args.quantized and args.quant_mode == "static" and not args.file_root:
            raise SystemExit("static export needs --file_root for calibration")
        cfg = _detection_config(args, file_root=args.file_root or "",
                                batch_size=args.calib_batch_size, num_workers=2)
        blob = export_model(_detection_model(args, cfg), args.out, batch=args.batch)
    print(f"exported {len(blob)} bytes to {args.out}", flush=True)
    return 0


def build_service(args):
    """The PredictService ``serve`` runs (warmed up unless --no_warmup)."""
    from change3d_tpu_torch.inference import (
        ArtifactPredictor,
        CaptionArtifactPredictor,
        CaptionPredictor,
        Predictor,
    )
    from change3d_tpu_torch.serving import PredictService

    if args.shard and args.artifact:
        raise SystemExit("--shard applies to checkpoint-backed serving (artifacts bake their "
                         "own single-device program; export per device instead)")
    if args.quantized and args.artifact:
        raise SystemExit("--quantized applies to checkpoint-backed serving (an artifact is "
                         "what it was exported as; export with --quantized instead)")
    if args.model_task == "cc":
        cfg, word_map = _cc_word_map(args)
        if args.artifact:
            predictor = CaptionArtifactPredictor(args.artifact, word_map, device=args.device)
        else:
            predictor = CaptionPredictor.from_checkpoint(
                _cc_model(args, cfg, word_map, _cc_backbone(args)), args.checkpoint,
                word_map=word_map, beam_size=args.beam_size,
                compute_dtype=_compute_dtype(args), device=args.device, shard=args.shard)
    elif args.artifact:
        predictor = ArtifactPredictor(args.artifact, device=args.device)
    else:
        from change3d_tpu_torch.train.loop import build_model

        predictor = Predictor.from_checkpoint(build_model(_detection_config(args)),
                                              args.checkpoint, compute_dtype=_compute_dtype(args),
                                              device=args.device, shard=args.shard)
    return PredictService(
        args.model_task, predictor, batch_size=args.batch_size, max_delay_ms=args.max_delay_ms,
        tiled=args.tiled, tile_overlap=args.tile_overlap, warmup=not args.no_warmup,
        buckets=tuple(int(b) for b in args.buckets.split(",")) if args.buckets else None,
        profile_dir=args.profile_dir)


def run_serve(args) -> int:
    from change3d_tpu_torch.serving import serve_forever

    serve_forever(build_service(args), args.host, args.port)
    return 0


def run_info(args) -> int:
    from change3d_tpu_torch.utils.model_info import format_info, model_info

    report = model_info(args.model_task, num_classes=args.num_class, in_height=args.in_height,
                        in_width=args.in_width, vocab_size=args.vocab_size,
                        embed_dim=args.embed_dim, n_head=args.n_head, n_layer=args.n_layer,
                        device=args.device)
    print(json.dumps(report) if args.json else format_info(report), flush=True)
    return 0


def run_convert_reference(args) -> int:
    """A reference-trained ``Trainer`` checkpoint -> ``{out}/best/model.pt``.
    num_class (and CC's vocabulary, width and depth) come from the weights
    where the flags leave them out."""
    import torch

    from change3d_tpu_torch.checkpoint.convert import convert_trainer_state_dict
    from change3d_tpu_torch.checkpoint.io import CheckpointManager
    from change3d_tpu_torch.models.trainer import Change3D, Task

    ckpt = torch.load(args.torch_checkpoint, map_location="cpu", weights_only=False)
    state = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    kw, num_class = {}, args.num_class
    if args.model_task == "cc":
        vocab, embed = state["decoder.vocab_embedding.weight"].shape
        n_layer = 1 + max(int(k.split(".")[3]) for k in state
                          if k.startswith("decoder.transformer.layers."))
        kw = dict(vocab_size=int(vocab), embed_dim=int(embed), num_heads=args.n_head,
                  num_layers=n_layer)
        num_class = 1
        print(f"inferred: vocab_size={vocab} embed_dim={embed} n_layer={n_layer}", flush=True)
    elif num_class is None:
        probe = {"bcd": "decoder", "scd": "decoder_pre", "bda": "decoder_cls"}[args.model_task]
        num_class = int(state[f"{probe}.up_c1.0.weight"].shape[0])
        print(f"inferred: num_class={num_class}", flush=True)
    model = Change3D(Task(args.model_task), num_classes=num_class, in_height=args.in_height,
                     in_width=args.in_width, device=args.device, **kw)
    model.load_state_dict(convert_trainer_state_dict(state, model.state_dict()))
    CheckpointManager(args.out).save_best(model)
    n = sum(p.numel() for p in model.parameters())
    print(f"converted {n:,} params -> {args.out}/best (use with 'predict/eval/serve "
          f"--checkpoint {args.out}')", flush=True)
    return 0


def run_verify_checkpoint(args) -> int:
    from change3d_tpu_torch.checkpoint.verify import (
        DEFAULT_ATOL,
        DEFAULT_RTOL,
        format_report,
        verify_checkpoint,
    )

    report = verify_checkpoint(
        args.pretrained, args.trace, t=args.frames, h=args.height, w=args.width, seed=args.seed,
        rtol=args.rtol if args.rtol is not None else DEFAULT_RTOL,
        atol=args.atol if args.atol is not None else DEFAULT_ATOL, device=args.device)
    print(format_report(report), flush=True)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if report["all_pass"] in (True, None) else 1


def run_classify(args) -> int:
    """Top-5 Kinetics classes per video: ``ClipClassifier.classify_u8`` on
    one video's ``--views`` clips a call, the views' softmax averaged."""
    import numpy as np

    from change3d_tpu_torch.checkpoint.convert import (
        load_x3d_pretrained,
        merge_backbone_variables,
    )
    from change3d_tpu_torch.inference import ClipClassifier
    from change3d_tpu_torch.models.x3d import x3d_classifier

    clips = np.load(args.clips, mmap_mode="r")
    if clips.dtype != np.uint8 or clips.ndim != 5 or clips.shape[-1] != 3:
        raise SystemExit(f"--clips holds {clips.dtype} {clips.shape}, not uint8 [N, T, H, W, 3]")
    if args.views < 1 or len(clips) % args.views:
        raise SystemExit(f"{len(clips)} clips do not split into videos of {args.views} views")
    model = x3d_classifier("l", device=args.device, seed=args.seed)
    if args.pretrained:
        backbone = load_x3d_pretrained(args.pretrained, model.cfg)
        model.load_state_dict(merge_backbone_variables(model.state_dict(), backbone,
                                                       drop_head=False))
    classifier = ClipClassifier(model, compute_dtype=_compute_dtype(args), device=args.device)
    videos = []
    for v in range(len(clips) // args.views):
        logits = classifier.classify_u8(clips[v * args.views:(v + 1) * args.views])
        e = np.exp(logits - logits.max(-1, keepdims=True))
        probs = (e / e.sum(-1, keepdims=True)).mean(0)
        top = np.argsort(-probs, kind="stable")[:5]
        videos.append({"video": v, "top5": [{"class": int(c), "prob": float(probs[c])}
                                            for c in top]})
    with open(args.out, "w") as f:
        json.dump(videos, f, indent=1)
    print(f"classified {len(videos)} videos of {args.views} views -> {args.out}", flush=True)
    return 0


_RUN = {"eval": run_eval, "serve": run_serve, "info": run_info, "export": run_export,
        "convert-reference": run_convert_reference, "verify-checkpoint": run_verify_checkpoint,
        "classify": run_classify}


def main(argv=None):
    """Runs one subcommand. The training subcommands return their results
    dict; the others an exit status (verify-checkpoint: 1 on a failed
    comparison)."""
    parser = build_parser()
    args = parser.parse_args(sys.argv[1:] if argv is None else list(argv))
    if getattr(args, "coordinator_address", None) or getattr(args, "num_processes", None):
        from change3d_tpu_torch.parallel.distributed import initialize

        initialize(args.coordinator_address, args.num_processes, args.process_id,
                   device=args.device)
    if args.task == "predict":
        return (run_predict_captions if args.model_task == "cc" else run_predict)(args)
    if args.task in _RUN:
        return _RUN[args.task](args)
    config, run = ((CaptionRunConfig, run_caption_training) if args.task == "cc"
                   else (RunConfig, run_detection_training))
    fields = {f.name for f in dataclasses.fields(config)}
    return run(config(**{k: v for k, v in vars(args).items() if k in fields}))


if __name__ == "__main__":
    from change3d_tpu_torch.parallel.distributed import shutdown

    result = main()
    shutdown()
    sys.exit(result if isinstance(result, int) else 0)
