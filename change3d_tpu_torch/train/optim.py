"""torch Adam with coupled L2 decay (counterpart of
``change3d_tpu/train/optim.py``): the decay is added to the gradient before
the moments, betas (0.9, 0.99), eps 1e-8 outside the square root — exactly
``torch.optim.Adam(weight_decay=...)``. With ``grad_clip_value`` every
gradient element is first clipped to +-value (``optax.clip`` ahead of
``add_decayed_weights``, CC). The learning rate is set from the schedule
before each step (``set_lr``).

CC's two optimizers: ``per_subtree_lr`` splits the parameters into an
``encoder`` and a ``decoder`` group whose learning rates ``set_lr`` sets
apart; ``freeze_subtree`` leaves a subtree out of the optimizer (and out of
autograd), so its parameters never move.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Union

import torch


class TorchAdam(torch.optim.Adam):
    """``torch.optim.Adam`` that clips each gradient element to
    +-``grad_clip_value`` before its step, when set."""

    def __init__(self, params, *, grad_clip_value: Optional[float] = None, **kw):
        super().__init__(params, **kw)
        self.grad_clip_value = grad_clip_value

    @torch.no_grad()
    def step(self, closure=None):
        if self.grad_clip_value is not None:
            torch.nn.utils.clip_grad_value_([p for g in self.param_groups for p in g["params"]],
                                            self.grad_clip_value)
        return super().step(closure)


def torch_adam(params: Iterable, *, lr: float = 0.0, b1: float = 0.9, b2: float = 0.99,
               eps: float = 1e-8, weight_decay: float = 0.0,
               grad_clip_value: Optional[float] = None) -> TorchAdam:
    return TorchAdam(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay,
                     grad_clip_value=grad_clip_value)


def per_subtree_lr(model: torch.nn.Module, prefix: str = "encoder") -> List[Dict]:
    """Two parameter groups, ``encoder`` (names under ``prefix``) and
    ``decoder`` (the rest), for separate learning rates."""
    groups = {"encoder": [], "decoder": []}
    for name, p in model.named_parameters():
        if p.requires_grad:
            groups["encoder" if name.split(".")[0] == prefix else "decoder"].append(p)
    return [{"params": ps, "name": n} for n, ps in groups.items() if ps]


def freeze_subtree(model: torch.nn.Module, prefix: str) -> List[torch.nn.Parameter]:
    """Stop gradients into the parameters under ``prefix`` and return the
    others, the ones an optimizer should take."""
    rest = []
    for name, p in model.named_parameters():
        if name.split(".")[0] == prefix:
            p.requires_grad_(False)
        else:
            rest.append(p)
    return rest


def set_lr(opt: torch.optim.Optimizer, lr: Union[float, Mapping[str, float]]) -> None:
    """One learning rate for every group, or one per group ``name``."""
    for group in opt.param_groups:
        group["lr"] = lr[group["name"]] if isinstance(lr, Mapping) else lr
