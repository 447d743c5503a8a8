"""Learning-rate schedules (counterpart of ``change3d_tpu/train/lr.py``):
plain functions step -> lr, evaluated on the host in fp32 with the JAX
formulas' operation order. Step k (0-based, the number of optimizer steps
already taken) uses ``schedule(k)``.

- poly: lr * (1 - step/max_iter)^0.9, with a 200-step linear warmup from
  0.1*lr to lr that applies only while ``step < steps_per_epoch``;
- step: lr * 0.1^(epoch // step_epochs);
- shrink (CC): lr * factor^(epoch // shrink_every_epochs), x0.5 every 10.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

_F = np.float32


def poly_warmup_schedule(base_lr: float, max_iter: int, steps_per_epoch: int,
                         power: float = 0.9, warmup_iters: int = 200) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        s = _F(step)
        lr = _F(base_lr) * np.power(np.maximum(_F(1.0) - s / _F(max_iter), _F(0.0)), _F(power))
        if step < steps_per_epoch and step < warmup_iters:
            lr = _F(base_lr * 0.9) * (s + _F(1.0)) / _F(warmup_iters) + _F(0.1 * base_lr)
        return float(lr)

    return schedule


def step_schedule(base_lr: float, steps_per_epoch: int, step_epochs: int) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        return float(_F(base_lr) * np.power(_F(0.1), _F(epoch // step_epochs)))

    return schedule


def shrink_schedule(base_lr: float, steps_per_epoch: int, shrink_every_epochs: int = 10,
                    factor: float = 0.5) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        return float(_F(base_lr) * np.power(_F(factor), _F(epoch // shrink_every_epochs)))

    return schedule
