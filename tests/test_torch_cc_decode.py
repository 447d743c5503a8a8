"""The caption decoder and beam search of change3d_tpu_torch against
change3d_tpu on the CPU: the attention pieces and LayerNorm (fp32 within
1e-5 of the largest magnitude, bf16 within two bf16 ulps of it), the
decoder's full decode, ``decode_step`` against column ``pos`` of ``decode``,
and ``beam_search_decode``'s tokens (exact) and scores (1e-5) at k = 1, 3, 5
in the KV-cached and the full-prefix mode, each held to JAX's search with
early exit on and off (the port's search always exits early, which changes
no result), a forced-tie stub whose log-probs tie at every step, and a
search in which nothing completes (the fallback to the best live beam). A
short length (10) keeps the JAX compiles cheap; dropout is 0.
``DecodeGraphs``' step, run eagerly over its reused buffers, is held to a
new search's exactly and to the full-prefix search's tokens, and its keys
to the shapes and tensors it reads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.models import caption_decoder as jcd
from change3d_tpu.ops import attention as jatt
from change3d_tpu_torch.checkpoint.convert import from_jax_variables
from change3d_tpu_torch.models import caption_decoder as cd
from change3d_tpu_torch.ops import attention as att

V, E, HEADS, LAYERS, L = 12, 32, 4, 2, 10
START, END, PAD = 2, 3, 0


def close(got, want, dtype=torch.float32, msg=""):
    """fp32: |d| <= 1e-5 max|want|; bf16: two bf16 ulps of max|want|."""
    got = got.detach().float().numpy()
    want = (want.float().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(jnp.asarray(want, jnp.float32)))
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    scale = float(np.abs(want).max())
    tol = 1e-5 * scale if dtype == torch.float32 else 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{msg}: max |d| {err} > {tol}"


def _params(seed):
    rs = np.random.RandomState(seed)
    return {"in_proj_w": rs.uniform(-0.3, 0.3, (E, 3 * E)).astype(np.float32),
            "in_proj_b": (0.1 * rs.randn(3 * E)).astype(np.float32),
            "out_w": rs.uniform(-0.3, 0.3, (E, E)).astype(np.float32),
            "out_b": (0.1 * rs.randn(E)).astype(np.float32)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_attention_pieces_match_jax(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    p = _params(0)
    rs = np.random.RandomState(1)
    q, kv = rs.randn(3, 7, E).astype(np.float32), rs.randn(3, 5, E).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tq, tkv = torch.from_numpy(q).to(dtype), torch.from_numpy(kv).to(dtype)
    jq, jkv = jnp.asarray(q, jdt), jnp.asarray(kv, jdt)
    close(att.project_q(tq, tp), jatt.project_q(jq, jp), dtype, "project_q")
    for g, w in zip(att.project_kv(tkv, tp), jatt.project_kv(jkv, jp)):
        close(g, w, dtype, "project_kv")
    close(att.multi_head_attention(tq, tkv, tkv, tp, HEADS),
          jatt.multi_head_attention(jq, jkv, jkv, jp, HEADS), dtype, "cross attention")
    np.testing.assert_array_equal(att.causal_mask(7).numpy(), np.asarray(jatt.causal_mask(7)))
    close(att.multi_head_attention(tq, tq, tq, tp, HEADS, attn_mask=att.causal_mask(7)),
          jatt.multi_head_attention(jq, jq, jq, jp, HEADS, attn_mask=jatt.causal_mask(7)),
          dtype, "causal self-attention")
    x = torch.from_numpy(rs.randn(3, 4, E).astype(np.float32)).to(dtype)
    ln = cd.LayerNorm(E)
    with torch.no_grad():
        ln.scale.copy_(torch.from_numpy(1 + 0.1 * rs.randn(E).astype(np.float32)))
        ln.bias.copy_(torch.from_numpy(0.1 * rs.randn(E).astype(np.float32)))
        got = ln(x)
    want = jcd.LayerNorm(E).apply({"params": {"scale": jnp.asarray(ln.scale.detach().numpy()),
                                              "bias": jnp.asarray(ln.bias.detach().numpy())}},
                                  jnp.asarray(x.float().numpy(), jdt))
    assert got.dtype == dtype
    close(got, want, dtype, "layer norm")


def decoder_pair(seed=0, end_bias=0.0, end_scale=1.0, embed_scale=1.0):
    """A JAX CaptionDecoder's initialised variables, bridged into the
    port's decoder (eval mode). ``end_bias`` is added to <end>'s output
    bias, ``end_scale`` scales its output column and ``embed_scale`` the
    embedding, so that <end>'s likelihood moves with the prefix."""
    jdec = jcd.CaptionDecoder(vocab_size=V, embed_dim=E, num_heads=HEADS, num_layers=LAYERS,
                              dropout=0.0)
    mem = jnp.zeros((1, 3, E), jnp.float32)
    variables = jax.device_get(jax.jit(jdec.init)(jax.random.PRNGKey(seed), mem,
                                                  jnp.zeros((1, 4), jnp.int32)))
    variables = jax.tree_util.tree_map(np.array, variables)
    variables["params"]["out_b"] = (
        0.1 * np.random.RandomState(seed).randn(V).astype(np.float32))
    variables["params"]["out_b"][END] += end_bias
    variables["params"]["out_w"][:, END] *= end_scale
    variables["params"]["vocab_embedding"] *= embed_scale
    dec = cd.CaptionDecoder(V, E, HEADS, LAYERS, 0.0, generator=torch.Generator().manual_seed(0))
    dec.load_state_dict(from_jax_variables(variables), strict=True)
    return jdec, variables, dec.eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_decode_and_decode_step_match_jax_and_each_other(dtype):
    jdec, variables, dec = decoder_pair(1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rs = np.random.RandomState(2)
    memory = rs.randn(3, 6, E).astype(np.float32)
    tokens = rs.randint(0, V, (3, L)).astype(np.int32)
    mem = torch.from_numpy(memory).to(dtype)
    want = jdec.apply(variables, jnp.asarray(tokens), jnp.asarray(memory, jdt), method=jdec.decode)
    with torch.no_grad():
        full = dec.decode(torch.from_numpy(tokens), mem)
        assert full.dtype == dtype
        close(full, want, dtype, "decode")
        kv = dec.precompute_memory_kv(mem)
        cache = dec.init_decode_cache(3, L, dtype)
        assert cache[0]["k"].dtype == dtype
        for pos in range(L):
            step, cache = dec.decode_step(torch.from_numpy(tokens[:, pos]), kv, cache, pos)
            close(step, full[:, pos], dtype, f"decode_step vs column {pos}")


def _torch_search(dec, memory, k, incremental, max_len=L):
    with torch.no_grad():
        return cd.beam_search_decode(
            dec.decode, torch.from_numpy(memory), beam_size=k, start_token=START,
            end_token=END, pad_token=PAD, max_len=max_len,
            incremental=cd.incremental_fns(dec) if incremental else None)


def _jax_search(jdec, variables, memory, k, incremental, early_exit, max_len=L):
    apply_tokens = lambda vs, tokens, mem: jdec.apply(vs, tokens, mem, method=jdec.decode)
    return jcd.beam_search_decode(
        apply_tokens, variables, jnp.asarray(memory), beam_size=k, start_token=START,
        end_token=END, pad_token=PAD, max_len=max_len,
        incremental=jcd.make_incremental_fns(jdec) if incremental else None,
        early_exit=early_exit)


def _same(got, want, msg):
    tokens, scores = got
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want[0]), err_msg=msg)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[1]), rtol=1e-5, err_msg=msg)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_beam_search_matches_jax(k):
    """Tokens exact, scores 1e-5, in both modes, against JAX's search with
    early exit on and off. The rows complete at different steps (k = 1:
    <end> at 2 and 7) or not at all (the fallback)."""
    jdec, variables, dec = decoder_pair(3, end_bias=1.0, end_scale=8.0, embed_scale=5.0)
    memory = np.random.RandomState(4).randn(4, 6, E).astype(np.float32)
    results = []
    for incremental in (True, False):
        got = _torch_search(dec, memory, k, incremental)
        for early_exit in (True, False):
            msg = f"k={k} incremental={incremental} jax early_exit={early_exit}"
            _same(got, _jax_search(jdec, variables, memory, k, incremental, early_exit), msg)
        results.append(got)
    for tokens, scores in results[1:]:  # every mode gives the same tokens
        assert torch.equal(tokens, results[0][0])
        np.testing.assert_allclose(scores.numpy(), results[0][1].numpy(), rtol=1e-6)
    done = (results[0][0] == END).any(1)
    assert done.any() and not done.all()
    if k == 1:
        assert sorted((results[0][0] == END).nonzero()[:, 1].tolist()) == [2, 7]


@pytest.mark.parametrize("k", [1, 3])
def test_nothing_completes_falls_back_to_the_best_live_beam(k):
    jdec, variables, dec = decoder_pair(5, end_bias=-100.0)
    memory = np.random.RandomState(6).randn(2, 6, E).astype(np.float32)
    got = _torch_search(dec, memory, k, True)
    assert cd.beam_search_decode.steps == L - 1 and not (got[0] == END).any()
    assert (got[1] > -1e8).all()  # a live beam's score, not the dead-slot sentinel
    _same(got, _jax_search(jdec, variables, memory, k, True, True), f"fallback k={k}")


def _tie_logits(pos, batch, xp):
    """Logits that tie: tokens 4..7 share the top value, the rest share
    another; <end> is unlikely until position 3, then the most likely."""
    row = xp.full((V,), -5.0)
    row = xp.where(xp.arange(V) >= 4, 0.0, row)
    row = xp.where(xp.arange(V) >= 8, -5.0, row)
    row = xp.where(xp.arange(V) == END, xp.where(pos >= 3, 1.0, -10.0), row)
    return xp.broadcast_to(row, (batch, V))


@pytest.mark.parametrize("k", [3, 5])
def test_forced_ties_rank_by_lower_index_as_jax_does(k):
    """A stub step whose log-probs tie at every step (dead slots tie at
    -1e9 as well), through both packages' KV-cached search, JAX's with early
    exit on and off."""

    def torch_step(tokens_t, mem_kv, cache, pos):
        cache[0]["k"][:, pos, 0] = tokens_t.float()  # a cache the beams reorder
        return torch.from_numpy(np.array(_tie_logits(pos, tokens_t.shape[0], np), np.float32)), cache

    torch_fns = (lambda mem: ((mem, mem),),
                 lambda b, n, dtype=None: ({"k": torch.zeros(b, n, 1)},), torch_step)

    def jax_step(variables, tokens_t, mem_kv, cache, pos):
        logits = _tie_logits(pos, tokens_t.shape[0], jnp).astype(jnp.float32)
        return logits, cache

    jax_fns = (lambda variables, mem: ((mem, mem),),
               lambda variables, b, n, dtype=None: ({"k": jnp.zeros((b, n, 1))},), jax_step)
    memory = np.zeros((2, 3, 4), np.float32)
    got = cd.beam_search_decode(None, torch.from_numpy(memory), beam_size=k,
                                start_token=START, end_token=END, pad_token=PAD, max_len=L,
                                incremental=torch_fns)
    # Every beam retires at step 4 (<end> at position 4): the search stops there.
    assert cd.beam_search_decode.steps == 4
    assert got[0][0, :5].tolist() == [START, 4, 4, 4, END]
    for early_exit in (True, False):
        want = jcd.beam_search_decode(None, None, jnp.asarray(memory), beam_size=k,
                                      start_token=START, end_token=END, pad_token=PAD,
                                      max_len=L, incremental=jax_fns, early_exit=early_exit)
        _same(got, want, f"ties k={k} jax early_exit={early_exit}")



def _graph_decoder(seed, end_bias):
    """A decoder drawn by torch alone (no JAX init) whose <end> moves with
    the prefix, as ``decoder_pair``'s does: attention biases 0.1-normal,
    <end>'s output column x8 and its bias + ``end_bias``, embedding x5."""
    g = torch.Generator().manual_seed(seed)
    dec = cd.CaptionDecoder(V, E, HEADS, LAYERS, 0.0, generator=g)
    with torch.no_grad():
        dec.out_b.copy_(0.1 * torch.randn(V, generator=g))
        dec.out_b[END] += end_bias
        dec.out_w[:, END] *= 8.0
        dec.vocab_embedding.mul_(5.0)
        for name, p in dec.named_parameters():
            if name.endswith(("in_proj_b", "attn.out_b")):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return dec.eval()


def _static_search(graphs, dec, memory, k):
    tokens, scores = graphs.search(memory, cd.incremental_fns(dec), beam_size=k,
                                   start_token=START, end_token=END, pad_token=PAD, max_len=L)
    return tokens, scores, cd.beam_search_decode.steps


def _new_search(dec, memory, k, incremental=True):
    """A search over buffers of its own (no ``graphs``), or the full-prefix one."""
    with torch.no_grad():
        out = cd.beam_search_decode(dec.decode, memory, beam_size=k, start_token=START,
                                    end_token=END, pad_token=PAD, max_len=L,
                                    incremental=cd.incremental_fns(dec) if incremental else None)
    return (*out, cd.beam_search_decode.steps)


@pytest.mark.parametrize("ending", ["early_exit", "end_suppressed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("k", [1, 3])
def test_graph_body_over_the_static_carry_equals_the_eager_search(k, dtype, ending):
    """``DecodeGraphs``' step, run eagerly on the CPU over its reused
    buffers (what a card captures and replays), gives a new search's
    tokens, scores and step count exactly, and in fp32 the full-prefix
    search's tokens and steps: with every beam retired before ``max_len``
    (the early exit fires, after 6 or 7 steps) and with <end> suppressed
    (all ``max_len - 1`` steps). The second search over the same buffers
    starts clean."""
    dec = _graph_decoder(1, 0.5 if ending == "early_exit" else -100.0)
    graphs = cd.DecodeGraphs(dec)
    for seed in (5, 6):
        memory = torch.from_numpy(np.random.RandomState(seed).randn(4, 6, E)
                                  .astype(np.float32)).to(dtype)
        want = _new_search(dec, memory, k)
        tokens, scores, steps = _static_search(graphs, dec, memory, k)
        assert torch.equal(tokens, want[0]) and torch.equal(scores, want[1])
        assert steps == want[2]
        if dtype == torch.float32:
            full = _new_search(dec, memory, k, incremental=False)
            assert torch.equal(tokens, full[0]) and steps == full[2]
        if ending == "early_exit":
            assert 5 < steps < L - 1 and (tokens == END).any(1).all()
        else:
            assert steps == L - 1 and not (tokens == END).any()
    assert graphs.stats["captures"] == graphs.stats["replays"] == 0
    assert graphs.stats["eager_steps"] > 0


def test_decode_graphs_key_shapes_and_replaced_parameters_not_updates():
    """A new batch and a replaced parameter miss (the replaced one drops
    every search of the old tensors); an update in place hits, and the
    next search reads the new weights."""
    dec = _graph_decoder(1, 0.5)
    graphs = cd.DecodeGraphs(dec)
    fns = cd.incremental_fns(dec)
    memory = torch.from_numpy(np.random.RandomState(5).randn(4, 6, E).astype(np.float32))
    find = lambda m: graphs._search_for(m, fns, 1, END, L)
    first = find(memory)
    assert find(memory) is first
    assert find(memory[:2]) is not first and len(graphs._searches) == 2
    before = _static_search(graphs, dec, memory, 1)
    dec.load_state_dict(_graph_decoder(7, 0.5).state_dict())
    assert find(memory) is first
    got = _static_search(graphs, dec, memory, 1)
    want = _new_search(dec, memory, 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[0], before[0])
    dec.out_b = torch.nn.Parameter(dec.out_b.detach().clone())
    replaced = find(memory)
    assert replaced is not first and len(graphs._searches) == 1
