"""Checkpoints through ``torch.save`` (counterpart of
``change3d_tpu/checkpoint/orbax_io.py``), with the same directory semantics:

  {save_dir}/ckpt/{step}/state.pt   model + optimizer state_dicts and the
                                    step; the newest ``max_to_keep`` steps kept
  {save_dir}/ckpt/train_meta.json   loop sidecar: best_val, preempted_at_step
  {save_dir}/best/model.pt          the metric-gated model state_dict

Every file is written to a temporary name and renamed, so a reader never
sees half a checkpoint. Tensors are saved on the CPU and restored onto the
model's own device.

In a multi-process run every process calls the same methods with the same
(replicated) state: process 0 writes, and every process then waits at a
barrier, so a file is whole before any process reads it or goes on.
Every process restores.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

from change3d_tpu_torch.parallel import distributed


def _cpu_state(state):
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    if isinstance(state, dict):
        return {k: _cpu_state(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_cpu_state(v) for v in state)
    return state


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _primary_writes(write):
    """Run ``write`` on process 0 only, then wait for every process."""
    if distributed.is_primary():
        write()
    distributed.barrier()


class CheckpointManager:
    def __init__(self, save_dir: str, max_to_keep: int = 2):
        self.dir = os.path.abspath(os.path.join(save_dir, "ckpt"))
        self.best_dir = os.path.abspath(os.path.join(save_dir, "best"))
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    def steps(self):
        """Saved steps, oldest first."""
        return sorted(int(d) for d in os.listdir(self.dir)
                      if d.isdigit() and os.path.exists(os.path.join(self.dir, d, "state.pt")))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: torch.nn.Module, opt: torch.optim.Optimizer) -> None:
        """Checkpoint the model, the optimizer and ``step``; drop the oldest
        steps beyond ``max_to_keep``."""

        def write():
            step_dir = os.path.join(self.dir, str(step))
            os.makedirs(step_dir, exist_ok=True)
            _save_atomic({"step": step, "model": _cpu_state(model.state_dict()),
                          "optimizer": _cpu_state(opt.state_dict())},
                         os.path.join(step_dir, "state.pt"))
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.dir, str(old)))

        _primary_writes(write)

    def restore(self, model: torch.nn.Module, opt: torch.optim.Optimizer) -> int:
        """Load the newest checkpoint into ``model`` and ``opt``; returns its
        step, or 0 (and leaves both as they are) when there is none."""
        step = self.latest_step()
        if step is None:
            return 0
        state = torch.load(os.path.join(self.dir, str(step), "state.pt"), map_location="cpu")
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["optimizer"])  # moves the moments to the params' device
        return int(state["step"])

    def save_best(self, model: torch.nn.Module) -> None:
        def write():
            os.makedirs(self.best_dir, exist_ok=True)
            _save_atomic(_cpu_state(model.state_dict()), os.path.join(self.best_dir, "model.pt"))

        _primary_writes(write)

    def restore_best(self, model: torch.nn.Module) -> None:
        """Load the best weights into ``model``; FileNotFoundError when no
        best model was saved."""
        model.load_state_dict(restore_best_state(os.path.dirname(self.best_dir)))

    @property
    def _meta_path(self) -> str:
        return os.path.join(self.dir, "train_meta.json")

    def save_meta(self, meta: dict) -> None:
        def write():
            tmp = self._meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, self._meta_path)

        _primary_writes(write)

    def load_meta(self) -> dict:
        try:
            with open(self._meta_path) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}


def restore_best_state(run_dir: str) -> dict:
    """The model state_dict of ``{run_dir}/best/model.pt`` (CPU tensors);
    FileNotFoundError when the run saved no best model."""
    return torch.load(os.path.join(run_dir, "best", "model.pt"), map_location="cpu")


def restore_latest_state(run_dir: str):
    """(model state_dict, step) of the newest ``{run_dir}/ckpt/{step}``;
    FileNotFoundError when the run holds no checkpoint."""
    ckpt = os.path.join(run_dir, "ckpt")
    steps = sorted(int(d) for d in (os.listdir(ckpt) if os.path.isdir(ckpt) else ())
                   if d.isdigit() and os.path.exists(os.path.join(ckpt, d, "state.pt")))
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {ckpt}")
    state = torch.load(os.path.join(ckpt, str(steps[-1]), "state.pt"), map_location="cpu")
    return state["model"], int(state["step"])
