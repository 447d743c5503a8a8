"""Multi-head attention with torch ``nn.MultiheadAttention`` weight semantics
(counterpart of ``change3d_tpu/ops/attention.py``), batch-first [B, L, E].

Parameters (the JAX names and layouts):
  in_proj_w: [E, 3E]   (torch in_proj_weight [3E, E], transposed)
  in_proj_b: [3E]
  out_w:     [E, E]    (torch out_proj.weight, transposed)
  out_b:     [E]

The rounding points are JAX's: each projection is ``linear`` (fp32
accumulation, rounded to the activation dtype before its bias); the logits
are fp32 with the 1/sqrt(d) scale applied to q in q's dtype; the softmax runs
in fp32 and is cast to q's dtype before the PV product, which accumulates in
fp32 and rounds once. Explicit matmuls, not SDPA, so that bf16 rounds where
JAX rounds.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from change3d_tpu_torch.ops.layers import linear
from change3d_tpu_torch.parallel import distributed

Params = Dict[str, torch.Tensor]


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 - rate, scaled by
    1 / (1 - rate) in x's dtype, drawn from ``generator`` (on x's device;
    None takes torch's default generator there).

    Under a process group of more than one process, axis 0 of x is this
    process's slice of the global batch: the mask is drawn at the global
    batch's shape and cut to the slice, so a generator seeded alike on every
    process gives the single-process run's masks."""
    if rate <= 0.0:
        return x
    world, b = distributed.world_size(), x.shape[0]
    u = torch.rand((world * b,) + tuple(x.shape[1:]), generator=generator, device=x.device)
    if world > 1:
        u = u[distributed.rank() * b:(distributed.rank() + 1) * b]
    keep = u < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def project_q(x: torch.Tensor, params: Params) -> torch.Tensor:
    e = x.shape[-1]
    return linear(x, params["in_proj_w"][:, :e], params["in_proj_b"][:e])


def project_kv(x: torch.Tensor, params: Params, e: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project keys/values: [B, L, E] -> ([B, L, E], [B, L, E])."""
    e = e or x.shape[-1]
    w, bias = params["in_proj_w"], params["in_proj_b"]
    return linear(x, w[:, e:2 * e], bias[e:2 * e]), linear(x, w[:, 2 * e:], bias[2 * e:])


def attend_projected(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor, num_heads: int,
                     out_w: torch.Tensor, out_b: torch.Tensor, *,
                     attn_mask: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Attention over already-projected q/k/v [B, L, E]; ``attn_mask``
    additive, broadcastable to [Lq, Lkv]. The shared core of the
    full-sequence and KV-cached paths."""
    b, lq, e = qp.shape
    lkv = kp.shape[1]
    head_dim = e // num_heads
    if head_dim * num_heads != e:
        raise ValueError(f"embed dim {e} is not a multiple of {num_heads} heads")
    qh = qp.reshape(b, lq, num_heads, head_dim).transpose(1, 2)  # [B, H, Lq, D]
    kh = kp.reshape(b, lkv, num_heads, head_dim).transpose(1, 2)
    vh = vp.reshape(b, lkv, num_heads, head_dim).transpose(1, 2)
    scale = 1.0 / math.sqrt(head_dim)
    # bf16 products are exact in fp32: upcasting gives the fp32-accumulated
    # product (preferred_element_type=f32) without a bf16 rounding.
    logits = torch.matmul((qh * scale).float(), kh.float().transpose(-1, -2))
    if attn_mask is not None:
        logits = logits + attn_mask.float()
    weights = torch.softmax(logits, dim=-1).to(qp.dtype)
    weights = dropout(weights, dropout_rate, generator)
    out = torch.matmul(weights.float(), vh.float()).to(qp.dtype)
    out = out.transpose(1, 2).reshape(b, lq, e)
    return linear(out, out_w, out_b)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, params: Params,
                         num_heads: int, *, attn_mask: Optional[torch.Tensor] = None,
                         dropout_rate: float = 0.0,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """q: [B, Lq, E], k/v: [B, Lkv, E]; attn_mask additive [Lq, Lkv] or None."""
    e = q.shape[-1]
    kp, vp = project_kv(k, params, e)
    return attend_projected(project_q(q, params), kp, vp, num_heads, params["out_w"],
                            params["out_b"], attn_mask=attn_mask, dropout_rate=dropout_rate,
                            generator=generator)


def causal_mask(length: int, dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """Additive causal mask: 0 on and below the diagonal, -inf above."""
    return torch.triu(torch.full((length, length), float("-inf"), dtype=dtype, device=device),
                      diagonal=1)
