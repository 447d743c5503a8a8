"""Detection train-and-validate loop for BCD, SCD and BDA (counterpart of
``change3d_tpu/train/loop.py``).

The protocol is the JAX loop's: validation on the *test* split after every
epoch except epoch 0, the best model gated on the task's metric (BCD F1,
SCD IoU_mean, BDA overall_f1), the latest ``max_to_keep`` checkpoints and a
sidecar with the best value so far, and a final re-evaluation of the best
weights. Every step's loss adds into one device scalar, so the
host syncs once per epoch (and on the progress line every 50 steps).

``pretrained`` starts the backbone from a Kinetics ``X3D_L.pyth``.
``remat`` recomputes the backbone's block pairs in the backward (off by
default here: the JAX CLI's default-on was sized for a TPU's memory, and the
card holds the CLI-default step). ``run_detection_eval`` scores a saved run
(its best or latest weights) on any split through the same evaluation pass;
with ``quantized`` the backbone's pointwise convs run int8 (``quant_mode``
'dynamic', or 'static' with ranges calibrated on the first ``calib_batches``
train batches, ``calibrate_from_train_split``).

SIGTERM is honoured between steps: the loop saves the full state (model,
optimizer, step) and returns; ``--resume`` re-enters that epoch and skips
the batches already trained, so a preempted-and-resumed run ends bit-for-bit
where an uninterrupted one does. A preemption that lands on an epoch's last
step leaves that epoch unvalidated; the resumed run validates it first.

Under a process group (``parallel/distributed.py``) every process runs this
loop on its slice of each global batch: ``batch_size`` is the global batch,
rounded up to a multiple of the world size; the loaders shard by process;
the steps are the global batch's (``train/engine.py``), so every process
holds the same weights and scores; process 0 writes the logs and
checkpoints while the others wait; every process restores on ``resume``;
and a SIGTERM on any process stops every process after the same step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from change3d_tpu_torch.checkpoint.convert import load_x3d_pretrained, merge_backbone_variables
from change3d_tpu_torch.checkpoint.io import (
    CheckpointManager,
    restore_best_state,
    restore_latest_state,
)
from change3d_tpu_torch.data.datasets import DATASETS
from change3d_tpu_torch.data.pipeline import device_prefetch, make_data_loader, pair_collate
from change3d_tpu_torch.data.transforms import make_transform_pipelines
from change3d_tpu_torch.device import resolve_device
from change3d_tpu_torch.metrics.confusion import BDAMeter, BinaryChangeMeter, SCDMeter
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import X3DConfig, x3d_l_config
from change3d_tpu_torch.parallel import distributed
from change3d_tpu_torch.parallel.mesh import multiple_of_devices
from change3d_tpu_torch.train.engine import eval_step, train_step
from change3d_tpu_torch.train.lr import poly_warmup_schedule, step_schedule
from change3d_tpu_torch.train.optim import torch_adam
from change3d_tpu_torch.utils.logging import setup_logger
from change3d_tpu_torch.utils.profiling import WindowTracer

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
BEST_METRIC = {"bcd": "F1", "scd": "IoU_mean", "bda": "overall_f1"}


@dataclasses.dataclass
class RunConfig:
    task: str = "bcd"
    dataset: str = "LEVIR-CD"
    num_classes: int = 1
    file_root: str = ""
    save_dir: str = "./exp"
    in_height: int = 256
    in_width: int = 256
    max_steps: int = 80_000
    max_epochs: Optional[int] = None
    batch_size: int = 16
    lr: float = 2e-4
    lr_mode: str = "poly"
    step_loss: int = 100
    weight_decay: float = 1e-4
    resume: bool = False
    num_workers: int = 4
    loader: str = "threaded"  # or 'grain': worker processes (data/process_pipeline.py)
    seed: int = 16
    log_name: str = "train_val_log"
    compute_dtype: str = "bfloat16"
    device: str = "cuda"
    pretrained: Optional[str] = None  # a Kinetics X3D_L.pyth for the backbone
    profile_dir: Optional[str] = None  # a torch.profiler trace of steps 10-14
    remat: bool = False  # recompute the block pairs in the backward
    quantized: bool = False  # int8 pointwise convs at eval (ops/quant.py)
    quant_mode: str = "dynamic"  # 'dynamic' or 'static' (calibrated ranges)
    calib_batches: int = 8  # train batches that calibrate 'static'


class PreemptionGuard:
    """SIGTERM -> finish the step in flight, checkpoint, return.

    The handler only sets a flag; the loop polls it after each step and
    saves. The previous handler comes back on exit. Off the main thread
    (where ``signal.signal`` raises ValueError) the guard is a plain flag.

    ``CHANGE3D_PREEMPT_AFTER_STEP=N`` raises SIGTERM in process after the
    Nth optimizer step (``tick``): the real signal path at a fixed point.

    The loops ask ``agreed()`` after each step: true on every process of a
    group once any process has been signalled, so all stop after the same
    step (a process that stopped alone would leave the others waiting in
    the next collective).
    """

    def __init__(self):
        self._flag = threading.Event()
        self._prev = None
        self._installed = False
        self._hook_step = int(os.environ.get("CHANGE3D_PREEMPT_AFTER_STEP", "0") or 0)

    def __enter__(self) -> "PreemptionGuard":
        try:
            self._prev = signal.signal(signal.SIGTERM, self._on_signal)
            self._installed = True
        except ValueError:  # not the main thread
            pass
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)

    def _on_signal(self, signum, frame) -> None:
        # Flag first; os.write is async-signal-safe where print is not.
        self._flag.set()
        os.write(2, b"[preempt] SIGTERM: finishing the in-flight step, then "
                    b"checkpoint-and-exit (resume with --resume)\n")

    def tick(self, global_step: int) -> None:
        if self._hook_step and global_step >= self._hook_step:
            self._hook_step = 0
            if self._installed:
                signal.raise_signal(signal.SIGTERM)
            else:
                self._flag.set()

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()

    def agreed(self) -> bool:
        """Whether any process of the group has been signalled (this one
        alone without a group); sets the flag here when one has."""
        if distributed.any_process(self.triggered):
            self._flag.set()
        return self.triggered


def backbone_config(cfg: RunConfig, base: Optional[X3DConfig] = None) -> X3DConfig:
    """``base`` (X3D-L) with ``cfg``'s remat and int8 settings."""
    return dataclasses.replace(base or x3d_l_config(), remat=cfg.remat,
                               quantized_eval=cfg.quantized, quant_mode=cfg.quant_mode)


def build_model(cfg: RunConfig) -> Change3D:
    """The full-width X3D-L model of ``cfg.task`` with ``cfg.num_classes``
    classes (``backbone_config``), initialised from a generator seeded with
    ``cfg.seed``, on ``cfg.device``."""
    return Change3D(Task(cfg.task), num_classes=cfg.num_classes, in_height=cfg.in_height,
                    in_width=cfg.in_width, backbone_cfg=backbone_config(cfg),
                    device=cfg.device, generator=torch.Generator().manual_seed(cfg.seed))


def calibrate_from_train_split(cfg: RunConfig, model: Change3D) -> Dict[str, torch.Tensor]:
    """Static int8 ranges of ``model`` from its first ``cfg.calib_batches``
    train batches (eval transform, ``cfg.batch_size``, unsharded, the last
    batch ragged), as the JAX loop calibrates: never on the split being
    scored. Returns ``inference.calibrate_quant_scales``' ranges, which are
    now the model's."""
    from change3d_tpu_torch.inference import calibrate_quant_scales

    _, eval_tf = make_transform_pipelines(cfg.task, cfg.in_width, cfg.in_height)
    loader = make_data_loader(
        cfg.loader, DATASETS[cfg.task](cfg.file_root, "train", eval_tf), cfg.batch_size,
        shuffle=False, num_workers=cfg.num_workers, collate=pair_collate, drop_last=False,
        num_shards=1, shard_index=0,
    )
    batches = []
    for i, batch in enumerate(loader):
        if i >= cfg.calib_batches:
            break
        batches.append((batch["pre"], batch["post"]))
    scales = calibrate_quant_scales(model, batches)
    print(f"static int8: calibrated on {len(batches)} train batches", flush=True)
    return scales


def load_pretrained_backbone(model: torch.nn.Module, path: str) -> None:
    """Load a Kinetics ``X3D_L.pyth`` into ``model``'s backbone (strict
    conversion; the stages the task does not build and the head dropped)."""
    backbone = load_x3d_pretrained(path, model.backbone_cfg)
    model.load_state_dict(merge_backbone_variables(model.state_dict(), backbone))
    print(f"Loaded pretrained backbone: {path}", flush=True)


def restore_run_state(run_dir: str, which: str = "best") -> dict:
    """A saved run's model state_dict: ``best`` (the metric-gated weights)
    or ``latest`` (the newest checkpoint step)."""
    if which == "best":
        return restore_best_state(run_dir)
    if which != "latest":
        raise ValueError(f"which={which!r}: 'best' or 'latest'")
    state, step = restore_latest_state(run_dir)
    print(f"evaluating latest checkpoint (step {step})", flush=True)
    return state


def _make_meter(task: str, num_classes: int):
    if task == "bcd":
        return BinaryChangeMeter()
    if task == "scd":
        return SCDMeter(num_classes=num_classes)
    return BDAMeter(num_classes=num_classes)


def _update_meter(task: str, meter, metrics: Dict[str, torch.Tensor]) -> None:
    if task == "bcd":
        meter.update(metrics["cm"])
    elif task == "scd":
        meter.update(metrics["cm"], metrics["acc_correct"], metrics["acc_total"])
    else:
        meter.update(metrics["loc_cm"], metrics["cls_cm"])


def _evaluate_split(cfg: RunConfig, model, loader, device, compute_dtype) -> Dict[str, float]:
    """One metered pass over an eval loader."""
    meter = _make_meter(cfg.task, cfg.num_classes)
    losses = []
    for batch in device_prefetch(loader, device):
        metrics = eval_step(model, batch, compute_dtype=compute_dtype)
        losses.append(float(metrics["loss"]))
        _update_meter(cfg.task, meter, metrics)
    scores = {k: float(v) for k, v in meter.scores().items()}
    scores["loss"] = float(np.mean(losses)) if losses else float("nan")
    return scores


def _check_config(cfg: RunConfig) -> RunConfig:
    """``cfg`` with its batch rounded up to a multiple of the world size."""
    if cfg.task not in DATASETS:
        raise ValueError(f"task {cfg.task!r}: one of {sorted(DATASETS)}")
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of {sorted(_DTYPES)}")
    if cfg.quant_mode not in ("dynamic", "static"):
        raise ValueError(f"quant_mode {cfg.quant_mode!r}: 'dynamic' or 'static'")
    return _global_batch(cfg, "batch_size")


def _global_batch(cfg, *fields):
    """``cfg`` with each named batch size rounded up to a multiple of the
    world size (said when it changes)."""
    n = distributed.world_size()
    for field in fields:
        size = getattr(cfg, field)
        rounded = multiple_of_devices(size, n)
        if rounded != size:
            print(f"{field} {size} rounded up to {rounded} (must divide over {n} processes)",
                  flush=True)
            cfg = dataclasses.replace(cfg, **{field: rounded})
    return cfg


def run_detection_eval(cfg: RunConfig, run_dir: Optional[str] = None, split: str = "test",
                       which: str = "best") -> Dict[str, float]:
    """Score a saved run on ``split`` without training: its ``best`` or
    ``latest`` weights (``which``), the eval transform, ``cfg.batch_size``
    with the last batch padded and masked, ``cfg.compute_dtype``, every
    stride-1 block fused on the card (int8 pointwise convs instead with
    ``cfg.quantized``; 'static' calibrates on the train split first).
    ``run_dir`` defaults to the training loop's
    ``{save_dir}/{dataset}_iter_{max_steps}_lr_{lr}``."""
    cfg = _check_config(cfg)
    device = resolve_device(cfg.device)
    run_dir = run_dir or os.path.join(cfg.save_dir, f"{cfg.dataset}_iter_{cfg.max_steps}_lr_{cfg.lr}")
    _, eval_tf = make_transform_pipelines(cfg.task, cfg.in_width, cfg.in_height)
    loader = make_data_loader(
        cfg.loader, DATASETS[cfg.task](cfg.file_root, split, eval_tf), cfg.batch_size,
        shuffle=False, num_workers=cfg.num_workers, collate=pair_collate, pad_final=True,
    )
    model = build_model(cfg)
    model.load_state_dict(restore_run_state(run_dir, which))
    if cfg.quantized and cfg.quant_mode == "static":
        calibrate_from_train_split(cfg, model)
    return _evaluate_split(cfg, model, loader, device, _DTYPES[cfg.compute_dtype])


def run_detection_training(cfg: RunConfig) -> Dict[str, Any]:
    """Train and validate BCD, SCD or BDA; returns {'last', 'test_best'}
    scores, or {'preempted_at_step'} after a SIGTERM."""
    cfg = _check_config(cfg)
    save_path = os.path.join(cfg.save_dir, f"{cfg.dataset}_iter_{cfg.max_steps}_lr_{cfg.lr}")
    with setup_logger(save_path, dataclasses.asdict(cfg), cfg.log_name) as logger:
        return _run_detection(cfg, logger, save_path)


def _run_detection(cfg: RunConfig, logger, save_path: str) -> Dict[str, Any]:
    device = resolve_device(cfg.device)
    compute_dtype = _DTYPES[cfg.compute_dtype]
    train_tf, eval_tf = make_transform_pipelines(cfg.task, cfg.in_width, cfg.in_height)
    train_data = DATASETS[cfg.task](cfg.file_root, "train", train_tf)
    test_data = DATASETS[cfg.task](cfg.file_root, "test", eval_tf)
    train_loader = make_data_loader(
        cfg.loader, train_data, cfg.batch_size, shuffle=True, seed=cfg.seed,
        num_workers=cfg.num_workers, collate=pair_collate, drop_last=True,
    )
    test_loader = make_data_loader(
        cfg.loader, test_data, cfg.batch_size, shuffle=False, num_workers=cfg.num_workers,
        collate=pair_collate, pad_final=True,
    )
    max_batches = max(len(train_loader), 1)
    max_epochs = cfg.max_epochs or int(np.ceil(cfg.max_steps / max_batches))

    model = build_model(cfg)
    if cfg.pretrained:
        load_pretrained_backbone(model, cfg.pretrained)
    if cfg.lr_mode == "poly":
        schedule = poly_warmup_schedule(cfg.lr, max_batches * max_epochs, max_batches)
    else:
        schedule = step_schedule(cfg.lr, max_batches, cfg.step_loss)
    opt = torch_adam(model.parameters(), weight_decay=cfg.weight_decay)

    ckpt = CheckpointManager(save_path)
    best_val = -1.0
    start_epoch = resume_step = skip_batches = 0
    if cfg.resume:
        resume_step = ckpt.restore(model, opt)
        start_epoch, skip_batches = divmod(resume_step, max_batches)
        best_val = float(ckpt.load_meta().get("best_val", -1.0))
        print(f"[resume] restored step {resume_step}", flush=True)
    results: Dict[str, Any] = {"resumed_from_step": resume_step}

    def evaluate() -> Dict[str, float]:
        return _evaluate_split(cfg, model, test_loader, device, compute_dtype)

    def validate(epoch: int) -> None:
        nonlocal best_val
        scores = evaluate()
        logger.log_epoch(epoch, scores)
        print(f"[epoch {epoch}] val {scores}", flush=True)
        if scores[BEST_METRIC[cfg.task]] >= best_val:
            best_val = scores[BEST_METRIC[cfg.task]]
            ckpt.save_best(model)
        ckpt.save_meta({"best_val": best_val})
        results["last"] = scores

    # A preemption on an epoch's last step: that epoch trained fully but
    # was never validated (epoch 0 never is).
    if (cfg.resume and resume_step > 0 and skip_batches == 0 and start_epoch - 1 >= 1
            and int(ckpt.load_meta().get("preempted_at_step", -1)) == resume_step):
        print(f"[resume] epoch {start_epoch - 1} completed right at the preemption point "
              f"but was never evaluated — evaluating now", flush=True)
        validate(start_epoch - 1)

    host_step = resume_step
    tracer = WindowTracer(cfg.profile_dir, device=device)
    with PreemptionGuard() as guard, contextlib.closing(tracer):
        for epoch in range(start_epoch, max_epochs):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            n_batches = len(train_loader)
            if epoch == start_epoch and skip_batches:
                print(f"[resume] epoch {epoch}: skipping {skip_batches} already-trained "
                      f"batches (mid-epoch checkpoint)", flush=True)
            batches = train_loader.iter_from(skip_batches if epoch == start_epoch else 0)
            loss_sum, n_steps = None, 0
            for i, batch in enumerate(device_prefetch(batches, device)):
                tracer.tick(i)
                metrics = train_step(model, opt, schedule, batch, host_step,
                                     compute_dtype=compute_dtype)
                loss_sum = metrics["loss"] if loss_sum is None else loss_sum + metrics["loss"]
                n_steps += 1
                host_step += 1
                guard.tick(host_step)
                if guard.agreed():
                    break
                if i % 50 == 0 and i:
                    eta = (time.time() - t0) / (i + 1) * (n_batches - i - 1)
                    print(f"  [epoch {epoch}] iter {i}/{n_batches} "
                          f"loss {float(metrics['loss']):.4f} eta {eta:.0f}s", flush=True)
            tracer.close()
            if guard.triggered:
                ckpt.save(host_step, model, opt)
                ckpt.save_meta({"best_val": best_val, "preempted_at_step": host_step})
                print(f"[preempt] checkpoint saved at step {host_step}; exiting cleanly",
                      flush=True)
                results["preempted_at_step"] = host_step
                return results
            mean_loss = float(loss_sum) / n_steps if n_steps else float("nan")
            print(f"[epoch {epoch}] train loss {mean_loss:.4f} ({time.time() - t0:.1f}s)",
                  flush=True)
            if epoch == 0:
                continue  # the reference protocol: no validation after epoch 0
            validate(epoch)
            ckpt.save(host_step, model, opt)

    results["steps"] = host_step
    try:
        ckpt.restore_best(model)
    except FileNotFoundError as e:  # no epoch after 0 has validated
        print(f"best-model evaluation skipped (no best checkpoint): {e}")
        return results
    results["test_best"] = evaluate()
    logger.log_epoch(-1, results["test_best"], split="test_best")
    return results
