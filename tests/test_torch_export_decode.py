"""The caption decoder's tensor-position step and the ``while_loop`` beam
search (``beam_search_loop``) on the CPU: the step at a 0-d tensor position
equals the step at the same int position and column ``pos`` of the full
re-decode; ``beam_search_loop`` gives the Python loop's tokens (exact) and
scores (equal) and JAX's (``change3d_tpu`` ``beam_search_decode``, tokens
exact, scores 1e-5) at k = 1, 3 and 5, on the decoder of
tests/test_torch_cc_decode.py whose rows end at different steps or not at
all (the fallback to the best live beam); and on the forced-tie stub, where
ties go to the lower index. Other batch sizes run through the exported loop
(tests/test_torch_export_cc.py). The loop runs eagerly here (``while_loop`` traces itself);
``export.py`` runs it exported (tests/test_torch_export_cc.py)."""

import numpy as np
import pytest
import torch

from change3d_tpu_torch.models import caption_decoder as cd

from tests.test_torch_cc_decode import (
    END,
    HEADS,
    PAD,
    START,
    E,
    L,
    V,
    _jax_search,
    _same,
    _torch_search,
    close,
    decoder_pair,
)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_tensor_position_step_equals_int_step_and_full_decode(dtype):
    _, _, dec = decoder_pair(1)
    rs = np.random.RandomState(2)
    mem = torch.from_numpy(rs.randn(3, 6, E).astype(np.float32)).to(dtype)
    tokens = torch.from_numpy(rs.randint(0, V, (3, L)))
    with torch.no_grad():
        full = dec.decode(tokens, mem)
        kv = dec.precompute_memory_kv(mem)
        by_int = by_tensor = dec.init_decode_cache(3, L, dtype)
        for pos in range(L):
            a, by_int = dec.decode_step(tokens[:, pos], kv, by_int, pos)
            b, by_tensor = dec.decode_step(tokens[:, pos], kv, by_tensor,
                                           torch.tensor(pos, dtype=torch.int64))
            assert torch.equal(a, b), pos
            close(b, full[:, pos], dtype, f"tensor step vs column {pos}")
        for c_int, c_tensor in zip(by_int, by_tensor):
            assert all(torch.equal(c_int[n], c_tensor[n]) for n in ("k", "v"))


def _loop(dec, memory, k):
    with torch.no_grad():
        return cd.beam_search_loop(torch.from_numpy(memory), beam_size=k, start_token=START,
                                   end_token=END, pad_token=PAD, max_len=L,
                                   incremental=cd.incremental_fns(dec))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_while_loop_search_equals_the_python_loop_and_jax(k):
    jdec, variables, dec = decoder_pair(3, end_bias=1.0, end_scale=8.0, embed_scale=5.0)
    memory = np.random.RandomState(4).randn(4, 6, E).astype(np.float32)
    got = _loop(dec, memory, k)
    want = _torch_search(dec, memory, k, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _same(got, _jax_search(jdec, variables, memory, k, True, True), f"while_loop k={k}")
    done = (got[0] == END).any(1)
    assert done.any() and not done.all()  # completions and the fallback both run


def test_forced_ties_rank_by_lower_index_in_the_while_loop():
    """Tokens 4..7 tie at every step; <end> wins from position 3."""
    bias = torch.full((V,), -5.0)
    bias[4:8] = 0.0

    def step(tokens_t, mem_kv, cache, pos):
        row = torch.where(torch.arange(V) == END, torch.where(pos >= 3, 1.0, -10.0), bias)
        k_new = cache[0]["k"].index_copy(1, pos.reshape(1), tokens_t.float()[:, None, None])
        return row.expand(tokens_t.shape[0], V), ({"k": k_new},)

    fns = (lambda mem: ((mem, mem),), lambda b, n, dtype=None: ({"k": torch.zeros(b, n, 1)},),
           step)
    memory = torch.zeros(2, 3, 4)
    for k in (3, 5):
        got = cd.beam_search_loop(memory, beam_size=k, start_token=START, end_token=END,
                                  pad_token=PAD, max_len=L, incremental=fns)
        want = cd.beam_search_decode(None, memory, beam_size=k, start_token=START,
                                     end_token=END, pad_token=PAD, max_len=L, incremental=fns)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[0][0, :5].tolist() == [START, 4, 4, 4, END]
