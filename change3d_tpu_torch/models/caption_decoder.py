"""Autoregressive caption decoder (transformer) and batched beam search
(counterpart of ``change3d_tpu/models/caption_decoder.py``).

The live path of the reference decoder layer: self-attention -> norm1 ->
cross-attention over the image memory -> norm2, with a sinusoidal position
encoding, a uniform(-0.1, 0.1) embedding and output projection, and dropout
where JAX puts it: the position encoding (always 0.1, ``pe_dropout``), the
attention weights, the two residual branches and before the output
projection. Dropout draws from the ``generator`` passed to ``forward`` /
``decode`` and is active only in ``train()`` mode.

Layout: batch-first [B, L, E]. Names are the JAX variable names
(``vocab_embedding``, ``layer{i}.{self_attn,cross_attn}.{in_proj_w,
in_proj_b,out_w,out_b}``, ``layer{i}.norm{1,2}.{scale,bias}``, ``out_w``,
``out_b``), so ``checkpoint/convert.py`` bridges the trees unchanged; the
position table is a buffer outside the state_dict.

``beam_search_decode`` keeps the JAX search step for step (retirement,
shrinking live width, running best, the -1e6 log-prob clamp, the fallback to
the best live beam, the k = 1 fast path) in fixed-shape device ops; ranking
ties go to the lower index, as ``jax.lax.top_k`` ranks them. The KV-cached
step is written once (``_search_step``) and run by one host loop
(``_search_loop``) over a ``_StaticSearch``'s buffers; ``DecodeGraphs``
alone decides whether a step is a CUDA graph replay (on a card) or eager
launches. ``beam_search_loop`` runs the same step in a ``while_loop`` for
``torch.export``.
"""

from __future__ import annotations

import itertools
import math
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from change3d_tpu_torch.init import kaiming_normal_relu_init, uniform_init, xavier_uniform_init
from change3d_tpu_torch.ops.attention import (
    attend_projected,
    causal_mask,
    dropout,
    multi_head_attention,
    project_kv,
    project_q,
)
from change3d_tpu_torch.ops.layers import linear
from change3d_tpu_torch.utils.profiling import span

MAX_CAPTION_LEN = 52
# The position table's length (JAX builds 5000 rows).
PE_ROWS = 5000

Cache = Tuple[Dict[str, torch.Tensor], ...]
MemoryKV = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


def sinusoidal_position_encoding(max_len: int, d_model: int) -> torch.Tensor:
    """[max_len, d_model] fp32: sin on even columns, cos on odd ones."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros((max_len, d_model), dtype=torch.float32)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class MHAParams(nn.Module):
    """A torch ``nn.MultiheadAttention``'s parameters in the JAX layout:
    in_proj Xavier-uniform, out_proj Kaiming-normal (ReLU gain), zero
    biases. Exposes the projection pieces the KV-cached decode uses."""

    def __init__(self, embed_dim: int, num_heads: int, dropout_rate: float,
                 generator: torch.Generator):
        super().__init__()
        e = embed_dim
        self.embed_dim, self.num_heads, self.dropout = e, num_heads, dropout_rate
        self.in_proj_w = nn.Parameter(xavier_uniform_init(generator, (e, 3 * e), e, 3 * e))
        self.in_proj_b = nn.Parameter(torch.zeros(3 * e))
        self.out_w = nn.Parameter(kaiming_normal_relu_init(generator, (e, e), e))
        self.out_b = nn.Parameter(torch.zeros(e))

    def params(self) -> Dict[str, torch.Tensor]:
        return {"in_proj_w": self.in_proj_w, "in_proj_b": self.in_proj_b,
                "out_w": self.out_w, "out_b": self.out_b}

    def forward(self, q, k, v, *, attn_mask=None, generator=None) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        return multi_head_attention(q, k, v, self.params(), self.num_heads, attn_mask=attn_mask,
                                    dropout_rate=rate, generator=generator)

    def project_kv(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return project_kv(x, self.params(), self.embed_dim)

    def attend_step(self, q_t, kp, vp, *, attn_mask=None) -> torch.Tensor:
        """Single-query attention against projected keys/values (no dropout)."""
        p = self.params()
        return attend_projected(project_q(q_t, p), kp, vp, self.num_heads, p["out_w"], p["out_b"],
                                attn_mask=attn_mask)


class LayerNorm(nn.Module):
    """torch nn.LayerNorm over the last axis, eps 1e-5, fp32 statistics,
    cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        return y.to(x.dtype)


class CaptionDecoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout_rate: float,
                 generator: torch.Generator):
        super().__init__()
        self.dropout = dropout_rate
        self.self_attn = MHAParams(embed_dim, num_heads, dropout_rate, generator)
        self.cross_attn = MHAParams(embed_dim, num_heads, dropout_rate, generator)
        self.norm1 = LayerNorm(embed_dim)
        self.norm2 = LayerNorm(embed_dim)

    def _drop(self, x, generator):
        return dropout(x, self.dropout if self.training else 0.0, generator)

    def forward(self, tgt, memory, *, tgt_mask=None, generator=None) -> torch.Tensor:
        sa = self.self_attn(tgt, tgt, tgt, attn_mask=tgt_mask, generator=generator)
        x1 = self.norm1(tgt + self._drop(sa, generator))
        ca = self.cross_attn(x1, memory, memory, generator=generator)
        return self.norm2(x1 + self._drop(ca, generator))

    def step(self, x_t: torch.Tensor, memory_kv, cache: Dict[str, torch.Tensor],
             pos: torch.Tensor, mask: torch.Tensor):
        """KV-cached single-token step (no dropout). x_t: [B, 1, E];
        memory_kv: this layer's projected cross-attention (k, v) [B, S, E];
        cache {'k', 'v'} [B, Lmax, E]; pos: a 0-d int64 tensor; mask: the
        additive causal row [1, Lmax] (0 at positions <= pos, -inf after).
        Returns (y_t [B, 1, E], the cache with column ``pos`` written, a new
        dict of new tensors): column ``pos`` of the full re-decode."""
        k_t, v_t = self.self_attn.project_kv(x_t)
        idx = pos.reshape(1)
        cache = {"k": cache["k"].index_copy(1, idx, k_t.to(cache["k"].dtype)),
                 "v": cache["v"].index_copy(1, idx, v_t.to(cache["v"].dtype))}
        sa = self.self_attn.attend_step(x_t, cache["k"], cache["v"], attn_mask=mask)
        x1 = self.norm1(x_t + sa)
        mk, mv = memory_kv
        return self.norm2(x1 + self.cross_attn.attend_step(x1, mk, mv)), cache


class CaptionDecoder(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int = 192, num_heads: int = 8,
                 num_layers: int = 3, dropout_rate: float = 0.1, *,
                 generator: torch.Generator):
        super().__init__()
        self.vocab_size, self.embed_dim, self.num_layers = vocab_size, embed_dim, num_layers
        self.dropout = dropout_rate
        self.pe_dropout = 0.1  # JAX's position-encoding dropout is fixed at 0.1
        self.vocab_embedding = nn.Parameter(uniform_init(generator, (vocab_size, embed_dim), 0.1))
        self.register_buffer("pe", sinusoidal_position_encoding(PE_ROWS, embed_dim),
                             persistent=False)
        # Position ids on the model's device: an int position indexes a 0-d
        # view of it, so a step never copies its position from the host.
        self.register_buffer("positions", torch.arange(PE_ROWS), persistent=False)
        for i in range(num_layers):
            self.add_module(f"layer{i}", CaptionDecoderLayer(embed_dim, num_heads, dropout_rate,
                                                             generator))
        self.out_w = nn.Parameter(uniform_init(generator, (embed_dim, vocab_size), 0.1))
        self.out_b = nn.Parameter(torch.zeros(vocab_size))

    def layers(self) -> List[CaptionDecoderLayer]:
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def decode(self, tokens: torch.Tensor, memory: torch.Tensor, *,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """tokens: [B, L] int, memory: [B, S, E] -> logits [B, L, V] in
        memory's dtype."""
        l = tokens.shape[1]
        x = F.embedding(tokens.long(), self.vocab_embedding).to(memory.dtype)
        x = x + self.pe[:l].to(x.dtype)
        train = self.training
        x = dropout(x, self.pe_dropout if train else 0.0, generator)
        mask = causal_mask(l, device=memory.device)
        for layer in self.layers():
            x = layer(x, memory, tgt_mask=mask, generator=generator)
        x = dropout(x, self.dropout if train else 0.0, generator)
        return linear(x, self.out_w, self.out_b)

    def forward(self, memory: torch.Tensor, captions: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced scores: position t predicts caption[t + 1]."""
        return self.decode(captions, memory, generator=generator)

    # -- KV-cached incremental decode (eval) --------------------------------

    def init_decode_cache(self, batch: int, max_len: int, dtype: Optional[torch.dtype] = None,
                          device=None) -> Cache:
        """Per-layer self-attention K/V caches [B, max_len, E] in ``dtype``
        (pass memory's, so bf16 serving carries bf16 caches)."""
        device = device if device is not None else self.out_w.device
        z = lambda: torch.zeros((batch, max_len, self.embed_dim), dtype=dtype or torch.float32,
                                device=device)
        return tuple({"k": z(), "v": z()} for _ in range(self.num_layers))

    def precompute_memory_kv(self, memory: torch.Tensor) -> MemoryKV:
        """Each layer's cross-attention keys/values, projected once per decode."""
        return tuple(layer.cross_attn.project_kv(memory) for layer in self.layers())

    def decode_step(self, tokens_t: torch.Tensor, memory_kv: MemoryKV, cache: Cache, pos):
        """tokens_t: [B] tokens at position ``pos`` (an int or a 0-d int64
        tensor) -> (logits [B, V] for position pos + 1, the caches with
        column ``pos`` written): column ``pos`` of ``decode`` on the full
        prefix at O(1) attention work per step. The caches are written out
        of place (``index_copy``), the position encoding read with
        ``index_select`` and the causal row built once for every layer, so a
        tensor position traces into one graph for every step
        (``beam_search_loop``)."""
        if not isinstance(pos, torch.Tensor):
            pos = self.positions[pos]
        x = F.embedding(tokens_t.long(), self.vocab_embedding)[:, None]
        x = x.to(memory_kv[0][0].dtype)
        x = x + self.pe.index_select(0, pos.reshape(1)).to(x.dtype)[None]
        lmax = cache[0]["k"].shape[1]
        mask = torch.where(self.positions[:lmax] > pos, float("-inf"), 0.0)[None]
        new_cache = []
        for layer, mkv, c in zip(self.layers(), memory_kv, cache):
            x, c = layer.step(x, mkv, c, pos, mask)
            new_cache.append(c)
        return linear(x[:, 0], self.out_w, self.out_b), tuple(new_cache)


_NEG_INF = -1e9


class _Beams(NamedTuple):
    """The search's carry: tokens [B*k, L], cumulative scores [B*k], the
    alive mask [B*k], live width per row [B], and the best completion so
    far per row (tokens [B, L], score [B])."""

    tokens: torch.Tensor
    scores: torch.Tensor
    alive: torch.Tensor
    n_live: torch.Tensor
    best_tokens: torch.Tensor
    best_scores: torch.Tensor


def _init_beams(b: int, k: int, max_len: int, start_token: int, pad_token: int,
                dev) -> _Beams:
    tokens = torch.full((b * k, max_len), pad_token, dtype=torch.int64, device=dev)
    tokens[:, 0] = start_token
    # Beam 0 live, the others at _NEG_INF, so the first expansion fans out of one beam.
    first = torch.arange(k, device=dev) == 0
    return _Beams(
        tokens=tokens,
        scores=torch.where(first, 0.0, _NEG_INF).to(torch.float32).repeat(b),
        alive=first.repeat(b),
        n_live=torch.full((b,), k, dtype=torch.int64, device=dev),
        best_tokens=torch.full((b, max_len), pad_token, dtype=torch.int64, device=dev),
        best_scores=torch.full((b,), _NEG_INF, dtype=torch.float32, device=dev),
    )


def _advance(beams: _Beams, logp: torch.Tensor, t: torch.Tensor, end_token: int,
             batch_ids: torch.Tensor, slot: torch.Tensor) -> Tuple[_Beams, torch.Tensor]:
    """One step of the search's bookkeeping, out of place: expand every live
    beam by ``logp`` [B*k, V] (fp32 log-probs), keep the top k per row,
    write the chosen tokens at position ``t`` (a 0-d int64 tensor), retire
    the beams that chose <end> and update the running best. Returns the new
    beams and the parent of each ([B*k] into the old beams; the caches
    follow it)."""
    b, k = batch_ids.shape[0], slot.shape[1]
    max_len = beams.tokens.shape[1]
    # Underflowed log-probs stay above the dead-slot sentinel.
    logp = torch.clamp_min(logp, -1e6)
    v = logp.shape[-1]
    cand = torch.where(beams.alive[:, None], beams.scores[:, None] + logp, _NEG_INF)
    cand = cand.reshape(b, k * v)
    if k == 1:
        top_idx = torch.argmax(cand, dim=-1, keepdim=True)  # first of equal maxima
        top_scores = torch.gather(cand, 1, top_idx)
        parent = batch_ids
        tokens = beams.tokens.reshape(b, 1, max_len)
    else:
        # Stable descending sort: equal scores rank by lower index (jax.lax.top_k).
        top_scores, top_idx = torch.sort(cand, dim=-1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        parent = (top_idx // v + batch_ids[:, None] * k).reshape(-1)
        tokens = beams.tokens[parent].reshape(b, k, max_len)
    tok_idx = top_idx % v
    tokens = tokens.index_copy(2, t.reshape(1), tok_idx[:, :, None])
    kept = (slot < beams.n_live[:, None]) & (top_scores > _NEG_INF / 2)
    done_now = kept & (tok_idx == end_token)
    masked = torch.where(done_now, top_scores, _NEG_INF)
    step_best, step_arg = masked.max(dim=1).values, torch.argmax(masked, dim=1)
    improved = step_best > beams.best_scores
    alive = (kept & ~done_now).reshape(-1)
    return _Beams(
        tokens=tokens.reshape(b * k, max_len),
        scores=torch.where(alive, top_scores.reshape(-1), _NEG_INF),
        alive=alive,
        n_live=beams.n_live - done_now.sum(dim=1),
        best_tokens=torch.where(improved[:, None], tokens[batch_ids, step_arg],
                                beams.best_tokens),
        best_scores=torch.where(improved, step_best, beams.best_scores),
    ), parent


def _result(beams: _Beams, batch_ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best completion of each row; with none, its best live beam."""
    b, max_len = batch_ids.shape[0], beams.tokens.shape[1]
    any_done = beams.best_scores > _NEG_INF / 2
    live_scores = torch.where(beams.alive, beams.scores, _NEG_INF).reshape(b, k)
    fb = torch.argmax(live_scores, dim=1)
    fb_tokens = beams.tokens.reshape(b, k, max_len)[batch_ids, fb]
    return (torch.where(any_done[:, None], beams.best_tokens, fb_tokens),
            torch.where(any_done, beams.best_scores, live_scores[batch_ids, fb]))


def _search_step(t: torch.Tensor, beams: _Beams, cache: Cache, mem_kv: MemoryKV,
                 step_fn: Callable, end_token: int, batch_ids: torch.Tensor,
                 slot: torch.Tensor) -> Tuple[_Beams, Cache]:
    """The KV-cached search's step at position ``t`` (0-d int64), out of
    place: ``step_fn`` on each beam's last token, the fp32 log-softmax,
    ``_advance``, and at k > 1 the caches reordered by ``parent``."""
    tokens_t = beams.tokens.index_select(1, (t - 1).reshape(1))[:, 0]
    step_logits, cache = step_fn(tokens_t, mem_kv, cache, t - 1)
    beams, parent = _advance(beams, torch.log_softmax(step_logits.float(), dim=-1), t,
                             end_token, batch_ids, slot)
    if slot.shape[1] > 1:
        # Beams follow their parents: the caches reorder with the gather.
        cache = tuple({n: a[parent] for n, a in c.items()} for c in cache)
    return beams, cache


def _search_loop(step: Callable[[int, _Beams], _Beams], beams: _Beams, max_len: int) -> _Beams:
    """``beams = step(t, beams)`` at t = 1, 2, ... until ``max_len`` or no
    beam is alive (after that no step changes the result), each under
    ``c3d.caption.step``; each check before a step after the first, the one
    wait for the device, under ``c3d.caption.alive_check``. The steps run
    are left in ``beam_search_decode.steps``."""
    t = 1
    while t < max_len:
        if t > 1:
            with span("c3d.caption.alive_check"):
                alive = bool(beams.alive.any())
            if not alive:
                break
        with span("c3d.caption.step"):
            beams = step(t, beams)
        t += 1
    beam_search_decode.steps = t - 1
    return beams


def beam_search_decode(
    apply_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]],
    memory: torch.Tensor,
    *,
    beam_size: int,
    start_token: int,
    end_token: int,
    pad_token: int = 0,
    max_len: int = MAX_CAPTION_LEN,
    incremental: Optional[Sequence[Callable]] = None,
    graphs: Optional["DecodeGraphs"] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape batched beam search with the JAX semantics: cumulative
    log-prob ranking; a beam that emits <end> retires (recorded, live width
    shrinks by one); the answer is the best completion over the whole
    search; with no completion, the best live beam. ``_search_loop`` runs
    it under ``c3d.caption.decode`` (``utils/profiling.py``).

    ``incremental`` = (precompute(memory) -> memory_kv, init_cache(batch,
    max_len, dtype) -> cache, step(tokens_t, memory_kv, cache, pos) ->
    (logits, cache)) decodes one token a step (``_search_step``) over the
    buffers of ``graphs`` (the model's ``DecodeGraphs``) or, without, of a
    new ``_StaticSearch`` stepped eagerly. Without ``incremental``,
    ``apply_fn(tokens [B*k, L], memory [B*k, S, E]) -> logits [B*k, L, V]``
    re-decodes the whole prefix each step: the reference the KV-cached
    search is held to.

    memory: [B, S, E]. Returns (tokens [B, max_len] int64, scores [B] fp32).
    """
    with span("c3d.caption.decode"):
        if incremental is not None:
            if graphs is not None:
                return graphs.search(memory, incremental, beam_size=beam_size,
                                     start_token=start_token, end_token=end_token,
                                     pad_token=pad_token, max_len=max_len)
            search = _StaticSearch(memory, incremental, beam_size, end_token, max_len,
                                   start_token, pad_token)
            return search.run({"eager_steps": 0})
        b, k, dev = memory.shape[0], beam_size, memory.device
        batch_ids = torch.arange(b, device=dev)
        slot = torch.arange(k, device=dev)[None, :]
        # Position t as a 0-d view of a device tensor: no copy from the host per step.
        steps = torch.arange(max_len, device=dev)
        # k = 1 (greedy): the repeat is the identity; skip it.
        mem = memory if k == 1 else memory.repeat_interleave(k, dim=0)  # [B*k, S, E]

        def step(t: int, beams: _Beams) -> _Beams:
            logp = torch.log_softmax(apply_fn(beams.tokens, mem)[:, t - 1].float(), dim=-1)
            return _advance(beams, logp, steps[t], end_token, batch_ids, slot)[0]

        beams = _search_loop(step, _init_beams(b, k, max_len, start_token, pad_token, dev),
                             max_len)
        return _result(beams, batch_ids, k)


beam_search_decode.steps = 0

# Eager steps on the side stream before a capture (cuBLAS handles and
# workspaces, the allocator's blocks for the step's temporaries).
_WARMUP_STEPS = 2


def _flat(cache: Cache) -> List[torch.Tensor]:
    return [a for c in cache for a in c.values()]


class _StaticSearch:
    """One search shape's carry in fixed buffers, and the search step over
    it: the position ``t`` (0-d int64), the beams, each layer's K/V cache and
    the projected memory, made ready for a search over ``memory``. ``step``
    reads and writes only these buffers, so a CUDA graph of it
    (``capture``) replays any search of the shape; ``beam_search_loop``
    takes them as its loop's first carry."""

    def __init__(self, memory: torch.Tensor, incremental: Sequence[Callable], k: int,
                 end_token: int, max_len: int, start_token: int = 0, pad_token: int = 0):
        self.precompute_fn, init_cache_fn, self.step_fn = incremental
        b, dev = memory.shape[0], memory.device
        self.b, self.k, self.end_token, self.max_len = b, k, end_token, max_len
        self.batch_ids = torch.arange(b, device=dev)
        self.slot = torch.arange(k, device=dev)[None, :]
        self.t = torch.ones((), dtype=torch.int64, device=dev)
        self.beams = _init_beams(b, k, max_len, start_token, pad_token, dev)
        self.cache = init_cache_fn(b * k, max_len, memory.dtype)
        self.mem_kv = self._project(memory)
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def _project(self, memory: torch.Tensor) -> MemoryKV:
        mem_kv = self.precompute_fn(memory)
        if self.k > 1:
            # Project from the un-repeated memory, then repeat the projections.
            mem_kv = tuple(tuple(a.repeat_interleave(self.k, dim=0) for a in kv)
                           for kv in mem_kv)
        return mem_kv

    def load(self, memory: torch.Tensor, start_token: int, pad_token: int) -> None:
        """Start a search over ``memory``: its projections copied in, the
        position at 1, the beams as ``_init_beams`` makes them, the caches
        zeroed."""
        for dst, src in zip(itertools.chain(*self.mem_kv),
                            itertools.chain(*self._project(memory))):
            dst.copy_(src)
        self.t.fill_(1)
        init = _init_beams(self.b, self.k, self.max_len, start_token, pad_token, self.t.device)
        for dst, src in zip(self.beams, init):
            dst.copy_(src)
        for a in _flat(self.cache):
            a.zero_()

    def step(self) -> None:
        """``_search_step`` at position ``t``, its new tensors copied back
        into the carry, then ``t`` advanced."""
        new, cache = _search_step(self.t, self.beams, self.cache, self.mem_kv, self.step_fn,
                                  self.end_token, self.batch_ids, self.slot)
        for dst, src in zip((*self.beams, *_flat(self.cache)), (*new, *_flat(cache))):
            dst.copy_(src)
        self.t.add_(1)

    def capture(self) -> None:
        """Warm up on a side stream, then capture one ``step`` into
        ``graph``. The warm-up moves the carry: ``load`` before the next
        search. The capture's errors are this thread's alone, so another
        thread's synchronisation (a server's completer) does not break it."""
        dev = self.t.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP_STEPS):
                self.t.fill_(1)  # every warm-up step at a column the buffers hold
                self.step()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.step()

    def run(self, stats: Dict[str, int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The search from the loaded carry (``_search_loop``), a step one
        replay of ``graph`` (under ``c3d.caption.replay``) once captured,
        else ``step`` run eagerly, counted in ``stats``. Returns (tokens,
        scores) as fresh tensors."""

        def step(t: int, beams: _Beams) -> _Beams:
            if self.graph is None:
                self.step()
                stats["eager_steps"] += 1
            else:
                with span("c3d.caption.replay"):
                    self.graph.replay()
                stats["replays"] += 1
            return beams

        _search_loop(step, self.beams, self.max_len)
        return _result(self.beams, self.batch_ids, self.k)


class DecodeGraphs:
    """CUDA graphs of ``beam_search_decode``'s KV-cached search step over
    ``module``'s parameters, one per search shape; one object per model
    replica (``CaptionPredictor`` makes them). The one place that decides
    whether a search is captured: on a card, at ``max_len`` > 1.

    A graph holds one whole step (``_search_step``: ``decode_step``, the
    log-softmax, ``_advance`` and, at k > 1, the cache reorder) over a
    ``_StaticSearch``'s buffers. A search copies its memory's projections
    in, resets the rest and replays the graph once a step; the early exit
    stays on the host, between replays. Tokens and scores equal the
    uncaptured search's.

    Searches are keyed on the device, batch·k, k, the memory's length, width
    and dtype, ``max_len`` and <end>. Replacing a parameter or buffer of
    ``module`` (a new ``nn.Parameter``, ``.to``) drops every graph; an update
    in place (``load_state_dict``, an optimiser step) is read by the next
    replay. On the CPU a search runs the same step eagerly over the same
    buffers. ``stats`` counts ``captures``, ``replays`` and ``eager_steps``
    (steps run over the buffers without a graph). One search at a time: the
    buffers are shared."""

    def __init__(self, module: nn.Module):
        self.module = module
        self.stats = {"captures": 0, "replays": 0, "eager_steps": 0}
        self._searches: Dict[tuple, _StaticSearch] = {}
        self._tensors: Tuple[int, ...] = ()
        self._lock = threading.Lock()

    def _search_for(self, memory: torch.Tensor, incremental: Sequence[Callable], k: int,
                    end_token: int, max_len: int) -> _StaticSearch:
        tensors = tuple(a.data_ptr() for a in itertools.chain(self.module.parameters(),
                                                             self.module.buffers()))
        if tensors != self._tensors:
            self._searches.clear()
            self._tensors = tensors
        b, s, e = memory.shape
        key = (memory.device, b * k, k, s, e, memory.dtype, max_len, end_token)
        search = self._searches.get(key)
        if search is None:
            search = _StaticSearch(memory, incremental, k, end_token, max_len)
            if memory.is_cuda and max_len > 1:
                search.capture()
                self.stats["captures"] += 1
            self._searches[key] = search  # kept only once its capture succeeded
        return search

    @torch.inference_mode()
    def search(self, memory: torch.Tensor, incremental: Sequence[Callable], *, beam_size: int,
               start_token: int, end_token: int, pad_token: int,
               max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``beam_search_decode``'s KV-cached search over this shape's
        buffers (``_StaticSearch.run``). Returns (tokens, scores) as fresh
        tensors."""
        with self._lock:
            search = self._search_for(memory, incremental, beam_size, end_token, max_len)
            search.load(memory, start_token, pad_token)
            return search.run(self.stats)


def beam_search_loop(
    memory: torch.Tensor,
    *,
    beam_size: int,
    start_token: int,
    end_token: int,
    incremental: Sequence[Callable],
    pad_token: int = 0,
    max_len: int = MAX_CAPTION_LEN,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``beam_search_decode``'s KV-cached search as one ``while_loop``
    (``torch._higher_order_ops``), as JAX runs it (one ``lax.while_loop``):
    the loop runs while ``t < max_len`` and any beam of the batch is alive,
    and its body is ``_search_step`` at a 0-d tensor position.
    ``torch.export`` traces it into one graph whatever the batch
    (``export.py``); its tokens and scores are the Python loop's.

    The carry holds fixed shapes and dtypes, and the body returns new
    tensors only (a carried input is never aliased). Run it traced; eagerly
    ``while_loop`` compiles itself, so ``beam_search_decode`` serves there.
    Returns (tokens [B, max_len] int64, scores [B] fp32).
    """
    from torch._higher_order_ops import while_loop

    s = _StaticSearch(memory, incremental, beam_size, end_token, max_len, start_token,
                      pad_token)
    names = [tuple(c) for c in s.cache]

    def unflatten(flat):
        it = iter(flat)
        return tuple({n: next(it) for n in c} for c in names)

    def cond(t, *carry):
        return (t < max_len) & _Beams(*carry[:6]).alive.any()

    def body(t, *carry):
        beams, cache = _search_step(t, _Beams(*carry[:6]), unflatten(carry[6:]), s.mem_kv,
                                    s.step_fn, end_token, s.batch_ids, s.slot)
        return (t + 1, *beams, *_flat(cache))

    out = while_loop(cond, body, (s.t, *s.beams, *_flat(s.cache)))
    return _result(_Beams(*out[1:7]), s.batch_ids, beam_size)


def incremental_fns(model) -> Tuple[Callable, Callable, Callable]:
    """(precompute, init_cache, step) for ``beam_search_decode``'s KV-cached
    mode, from a module with the decode-step surface (``CaptionDecoder``,
    or ``Change3D`` which forwards to its decoder)."""
    step = getattr(model, "decode_captions_step", None) or model.decode_step
    return (model.precompute_memory_kv,
            lambda batch, max_len, dtype=None: model.init_decode_cache(batch, max_len, dtype),
            step)
