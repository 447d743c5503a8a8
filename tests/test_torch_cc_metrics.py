"""CC scoring and training pieces of change3d_tpu_torch against
change3d_tpu: BLEU-1..4, ROUGE-L, CIDEr-D and METEOR on random token-id
corpora (the caption eval's protocol: stringified ids), the caption loss and
top-1 accuracy, the CC learning-rate schedule, the clipped Adam against
optax's clip -> add_decayed_weights -> Adam, and tokens_to_captions."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from change3d_tpu.inference import tokens_to_captions as jax_tokens_to_captions
from change3d_tpu.metrics import caption as jmetrics
from change3d_tpu.train.losses import (
    caption_cross_entropy as jax_caption_ce,
    caption_top_k_accuracy as jax_caption_topk,
)
from change3d_tpu.train.lr import shrink_schedule as jax_shrink_schedule
from change3d_tpu.train.optim import torch_adam as jax_torch_adam
from change3d_tpu_torch.inference import tokens_to_captions
from change3d_tpu_torch.metrics import caption as metrics
from change3d_tpu_torch.train.losses import caption_cross_entropy, caption_top_k_accuracy
from change3d_tpu_torch.train.lr import shrink_schedule
from change3d_tpu_torch.train.optim import set_lr, torch_adam


def _corpus(seed, n=24, vocab=9):
    """Hypotheses and 5 references per image from a small vocabulary, so
    n-grams repeat and match; some empty or one-token hypotheses."""
    rs = np.random.RandomState(seed)
    hyps, refs = [], []
    for i in range(n):
        length = 0 if i == 0 else (1 if i == 1 else rs.randint(2, 12))
        hyps.append(rs.randint(4, vocab, length).tolist())
        refs.append([rs.randint(4, vocab, rs.randint(1, 12)).tolist() for _ in range(5)])
    return refs, hyps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_caption_metrics_match_jax(seed):
    refs, hyps = _corpus(seed)
    got, want = metrics.eval_caption_scores(refs, hyps), jmetrics.eval_caption_scores(refs, hyps)
    assert set(got) == set(want) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                                     "ROUGE_L", "CIDEr"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k
    assert 0.0 < got["Bleu_1"] <= 1.0 and got["CIDEr"] > 0.0 and got["METEOR"] > 0.0


def test_each_corpus_metric_matches_jax():
    refs, hyps = _corpus(3)
    srefs = [[[str(t) for t in r] for r in rr] for rr in refs]
    shyps = [[str(t) for t in h] for h in hyps]
    assert metrics.corpus_bleu(srefs, shyps) == jmetrics.corpus_bleu(srefs, shyps)
    assert metrics.corpus_rouge_l(srefs, shyps) == jmetrics.corpus_rouge_l(srefs, shyps)
    assert metrics.corpus_cider_d(srefs, shyps) == jmetrics.corpus_cider_d(srefs, shyps)
    mrefs = [[" ".join(r) for r in rr] for rr in srefs]
    mhyps = [" ".join(h) for h in shyps]
    assert metrics.corpus_meteor(mrefs, mhyps) == pytest.approx(
        jmetrics.corpus_meteor(mrefs, mhyps), rel=1e-12)


def test_meteor_repeated_tokens_chunk_as_jax():
    """Repeated-token segments resolve through the max-coverage /
    min-chunk beam search, as the JAX scorer does."""
    cases = [(["7 7 5 7 7"], "7 7 7 5"), (["4 5 4 5 4 5"], "5 4 5 4"), (["6 6 6"], "6")]
    for refs, hyp in cases:
        assert metrics.corpus_meteor([refs], [hyp]) == pytest.approx(
            jmetrics.corpus_meteor([refs], [hyp]), rel=1e-12), (refs, hyp)


def test_caption_loss_and_top1_match_jax():
    rs = np.random.RandomState(4)
    logits = rs.randn(3, 9, 13).astype(np.float32)
    logits[0, 2, :] = logits[0, 2, 5]  # a tie: the lower index ranks first, as in JAX
    caps = rs.randint(1, 13, (3, 9)).astype(np.int32)
    caps[:, 6:] = 0
    caps[2, 3] = 0  # a padding target inside the length
    lengths = np.asarray([6, 9, 5], np.int32)
    t = lambda a: torch.from_numpy(a)
    np.testing.assert_allclose(
        float(caption_cross_entropy(t(logits), t(caps), t(lengths))),
        float(jax_caption_ce(jnp.asarray(logits), jnp.asarray(caps), jnp.asarray(lengths))),
        rtol=1e-6)
    for k in (1, 3):
        assert float(caption_top_k_accuracy(t(logits), t(caps), t(lengths), k=k)) == float(
            jax_caption_topk(jnp.asarray(logits), jnp.asarray(caps), jnp.asarray(lengths), k=k))
    none = np.zeros((2, 4), np.int32)  # no valid target: 0, not nan
    assert float(caption_cross_entropy(t(logits[:2, :4]), t(none), t(np.array([1, 1])))) == 0.0


def test_shrink_schedule_matches_jax():
    ours, theirs = shrink_schedule(1e-4, 7, 10, 0.5), jax_shrink_schedule(1e-4, 7, 10, 0.5)
    for step in (0, 6, 7, 69, 70, 71, 140, 1399, 1400):
        assert ours(step) == float(theirs(step)), step


def test_clipped_adam_matches_optax_over_three_steps():
    rs = np.random.RandomState(5)
    p0 = rs.randn(40).astype(np.float32)
    grads = [(3 * rs.randn(40)).astype(np.float32) for _ in range(3)]
    tx = jax_torch_adam(lambda _: 1e-2, weight_decay=1e-2, grad_clip_value=0.5)
    params, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch_adam([p], weight_decay=1e-2, grad_clip_value=0.5)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        set_lr(opt, 1e-2)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        assert float(p.grad.abs().max()) <= 0.5  # clipped in place, as torch clips
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=1e-5, atol=1e-7)


def test_tokens_to_captions_matches_jax():
    words = {"<pad>": 0, "<unk>": 1, "<start>": 2, "<end>": 3, "a": 4, "road": 5}
    tokens = np.asarray([[2, 4, 5, 3, 0, 0], [2, 9, 4, 3, 0, 0], [2, 3, 0, 0, 0, 0]])
    assert tokens_to_captions(tokens, words) == jax_tokens_to_captions(tokens, words) == [
        "a road", "<unk> a", ""]
