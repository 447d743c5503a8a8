"""The port's caption artifact (``export_caption_model``: the encoder and
the ``while_loop`` beam search) against the JAX package's on the CPU: the
bridged TINY CC model of tests/test_torch_cc_predict.py with its
<end>-biased decoder (every caption ends inside the 52 tokens, so the
loop's early exit runs), fp32. One symbolic-batch artifact per package and
beam width (1 here, 2 in tests/test_torch_export_cc_beam2.py), each run
at batch 4 and 3: tokens equal to JAX's and
to the live ``CaptionPredictor``'s, scores within 1e-5; the
``CaptionArtifactPredictor`` gives the sentences of JAX's tokens and of the
live predictor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.export import (
    export_caption_model as jax_export_caption_model,
    load_exported_captioner as jax_load_captioner,
)
from change3d_tpu.inference import tokens_to_captions as jax_tokens_to_captions
from change3d_tpu_torch import export as ex
from change3d_tpu_torch.checkpoint.convert import from_jax_variables
from change3d_tpu_torch.data.datasets import CaptionDataset
from change3d_tpu_torch.inference import CaptionArtifactPredictor, CaptionPredictor
from change3d_tpu_torch.models import caption_decoder as cd

from tests.test_torch_cc_model import HW, cc_pair
from tests.test_torch_cc_predict import WORDS


@pytest.fixture(scope="module")
def pair():
    jmodel, variables, model = cc_pair(True, seed=13)
    variables["params"]["decoder"]["out_b"][3] -= 2.0
    variables["params"]["decoder"]["out_w"][:, 3] *= 3.0
    model.load_state_dict(from_jax_variables(variables, model.backbone_cfg), strict=True)
    return jmodel, variables, model


def _images(seed, b):
    rs = np.random.RandomState(seed)
    norm = lambda a: (a.astype(np.float32) / 255.0 - CaptionDataset.MEAN) / CaptionDataset.STD
    return tuple(norm(rs.randint(0, 256, (b, HW, HW, 3))) for _ in range(2))


def check_beam(pair, beam):
    jmodel, variables, model = pair
    blob = ex.export_caption_model(model, WORDS, beam_size=beam, compute_dtype=torch.float32)
    jblob = jax_export_caption_model(jmodel, variables, WORDS, beam_size=beam,
                                     compute_dtype=jnp.float32, platforms=("cpu",))
    pred = CaptionArtifactPredictor(blob, WORDS, device="cpu")
    assert pred.fixed_batch is None and (pred.model.in_height, pred.model.in_width) == (HW, HW)
    jfn = jax_load_captioner(jblob)
    live = CaptionPredictor(model, WORDS, beam_size=beam, compute_dtype=torch.float32,
                            device="cpu")
    for seed, batch in ((14, 4), (15, 3)):
        pre, post = _images(seed, batch)
        tokens, scores = pred._fn(pre, post)
        assert tokens.dtype == torch.int32 and tokens.shape == (batch, cd.MAX_CAPTION_LEN)
        assert scores.dtype == torch.float32 and scores.shape == (batch,)
        want_tokens, want_scores = jfn(pre, post)
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
        np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-5)
        ended = (tokens == WORDS["<end>"]).any(1)
        assert ended.all() and (tokens[:, -1] == WORDS["<pad>"]).all()  # the loop stopped early
        live_tokens, live_scores = live.caption_device(torch.from_numpy(pre),
                                                       torch.from_numpy(post))
        assert torch.equal(tokens.long(), live_tokens)
        np.testing.assert_allclose(scores.numpy(), live_scores.numpy(), rtol=1e-5)
        if batch == 4:
            assert pred.caption(pre, post) == jax_tokens_to_captions(want_tokens, WORDS)


def test_caption_artifact_matches_jax_and_the_live_search(pair):
    check_beam(pair, 1)
