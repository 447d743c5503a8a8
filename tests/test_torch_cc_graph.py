"""The caption search's CUDA graphs (``DecodeGraphs``) on the card, against
the same KV-cached ``beam_search_decode`` run uncaptured (``graphs=None``: a
new static search stepped eagerly): bit-equal tokens and scores at k = 1
and 3, batch 4 and 16, fp32 and bf16, at the decoder's published widths;
``CaptionPredictor.caption_u8`` against the uncaptured search; one
capture per search shape and one replay per step; weights loaded in place
after the capture read by the replays.

Every test needs an NVIDIA GPU and skips without one. This file imports no
JAX:

    python -m pytest --noconftest tests/test_torch_cc_graph.py -q
"""

import numpy as np
import pytest
import torch

from change3d_tpu_torch.models import caption_decoder as cd

pytestmark = pytest.mark.cuda

V, E, HEADS, LAYERS, S = 500, 192, 8, 3, 64
START, END, PAD = 2, 3, 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    from change3d_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _decoder(dev, seed, end_bias):
    """A decoder at the CC widths whose output bias spreads the logits, so
    that the ranking and <end> (``end_bias`` more) move with the prefix."""
    g = torch.Generator().manual_seed(seed)
    dec = cd.CaptionDecoder(V, E, HEADS, LAYERS, 0.0, generator=g)
    with torch.no_grad():
        dec.out_b.copy_(0.5 * torch.randn(V, generator=g))
        dec.out_b[END] += end_bias
    return dec.to(dev).eval()


def _search(dec, memory, k, graphs=None):
    with torch.no_grad():
        tokens, scores = cd.beam_search_decode(
            None, memory, beam_size=k, start_token=START, end_token=END, pad_token=PAD,
            incremental=cd.incremental_fns(dec), graphs=graphs)
    return tokens, scores, cd.beam_search_decode.steps


def _memory(dev, seed, b, dtype):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, S, E, generator=g).to(dev, dtype)


@pytest.mark.parametrize("end_bias", [0.0, 2.5], ids=["long", "ends"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("k", [1, 3])
def test_graphed_search_is_bit_equal_to_the_eager_search(cuda, k, b, dtype, end_bias):
    """Two searches of one shape: one capture, one replay per step run,
    tokens, scores and steps equal to the uncaptured search's."""
    dec = _decoder(cuda, 0, end_bias)
    graphs = cd.DecodeGraphs(dec)
    steps = 0
    for seed in (1, 2):
        memory = _memory(cuda, seed, b, dtype)
        want = _search(dec, memory, k)
        got = _search(dec, memory, k, graphs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[2] == want[2]
        steps += got[2]
    assert graphs.stats == {"captures": 1, "replays": steps, "eager_steps": 0}
    _search(dec, _memory(cuda, 3, b + 1, dtype), k, graphs)
    assert graphs.stats["captures"] == 2


def test_loaded_weights_change_the_graphed_tokens_as_the_eager_ones(cuda):
    """``load_state_dict`` after the capture writes the weights in place:
    the next replay reads them, with no new capture."""
    dec, other = _decoder(cuda, 0, 0.0), _decoder(cuda, 5, 0.0)
    graphs = cd.DecodeGraphs(dec)
    memory = _memory(cuda, 1, 8, torch.bfloat16)
    before = _search(dec, memory, 1, graphs)
    dec.load_state_dict(other.state_dict())
    got, want = _search(dec, memory, 1, graphs), _search(dec, memory, 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[0], before[0])
    assert graphs.stats["captures"] == 1


@pytest.mark.parametrize("beam", [1, 3])
def test_caption_u8_equals_the_eager_search(cuda, beam):
    """The predictor's captions (graphed decode) are the uncaptured
    search's over the same memory."""
    from change3d_tpu_torch.inference import CaptionPredictor, tokens_to_captions
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3DConfig

    tiny = dict(stem_dim_out=8, stage_dims=(8, 16, 24, 32), stage_inner_dims=(18, 36, 54, 72),
                stage_depths=(2, 3, 3, 3))
    model = Change3D(Task.CC, backbone_cfg=X3DConfig(**tiny), in_height=32, in_width=32,
                     vocab_size=11, embed_dim=32, num_heads=4, num_layers=2, dropout=0.0,
                     device=cuda)
    words = {"<pad>": 0, "<unk>": 1, "<start>": 2, "<end>": 3}
    words.update({f"w{i}": i for i in range(4, 11)})
    pred = CaptionPredictor(model, words, beam_size=beam, compute_dtype=torch.bfloat16,
                            device=cuda)
    rs = np.random.RandomState(7)
    pre, post = (rs.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8) for _ in range(2))
    got = pred.caption_u8(pre, post)
    memory = pred.encode(torch.from_numpy(pre).to(cuda), torch.from_numpy(post).to(cuda))
    with torch.no_grad():
        tokens, _ = cd.beam_search_decode(
            model.decode_captions, memory, beam_size=beam, start_token=START, end_token=END,
            pad_token=PAD, incremental=cd.incremental_fns(model))
    assert got == tokens_to_captions(tokens.cpu().numpy(), words)
    stats = pred.decode_graphs[id(pred.model)].stats
    assert stats["captures"] == 1 and stats["replays"] == cd.beam_search_decode.steps
