"""``CaptionPredictor`` of change3d_tpu_torch against the JAX package's on
the bridged TINY CC model, fp32, on the CPU: ``caption`` on normalised
floats and ``caption_u8`` on uint8 pixels (ImageNet mean / std on the
device, not the detection normalisation) give the JAX sentences at beam 1
and 3, and ``caption_device`` the JAX tokens. The decoder's <end> column is
scaled and its bias lowered so that the captions end well inside
MAX_CAPTION_LEN (16 and 17 words)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.inference import CaptionPredictor as JaxCaptionPredictor
from change3d_tpu_torch.checkpoint.convert import from_jax_variables
from change3d_tpu_torch.data.datasets import CaptionDataset
from change3d_tpu_torch.inference import CaptionPredictor
from change3d_tpu_torch.models import caption_decoder as cd

from tests.test_torch_cc_model import VOCAB, cc_pair

WORDS = {"<pad>": 0, "<unk>": 1, "<start>": 2, "<end>": 3}
WORDS.update({f"w{i}": i for i in range(4, VOCAB)})


@pytest.fixture(autouse=True)
def _two_threads():
    """The decode runs thousands of tiny ops; under a parallel test run
    many intra-op threads per process only contend for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    jmodel, variables, model = cc_pair(True, seed=13)
    variables["params"]["decoder"]["out_b"][3] -= 2.0
    variables["params"]["decoder"]["out_w"][:, 3] *= 3.0
    model.load_state_dict(from_jax_variables(variables, model.backbone_cfg), strict=True)
    rs = np.random.RandomState(14)
    u8 = tuple(rs.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8) for _ in range(2))
    return jmodel, variables, model, u8


@pytest.mark.parametrize("beam", [1, 3])
def test_caption_predictor_matches_jax(pair, beam):
    jmodel, variables, model, (pre_u8, post_u8) = pair
    norm = lambda a: (a.astype(np.float32) / 255.0 - CaptionDataset.MEAN) / CaptionDataset.STD
    pred = CaptionPredictor(model, WORDS, beam_size=beam, compute_dtype=torch.float32,
                            device="cpu")
    jpred = JaxCaptionPredictor(jmodel, variables, WORDS, beam_size=beam,
                                compute_dtype=jnp.float32)
    want = jpred.caption_u8(pre_u8, post_u8)
    assert pred.caption_u8(pre_u8, post_u8) == want
    assert pred.caption(norm(pre_u8), norm(post_u8)) == jpred.caption(norm(pre_u8),
                                                                      norm(post_u8)) == want
    lengths = {len(c.split()) for c in want}
    assert 0 < min(lengths) and max(lengths) < cd.MAX_CAPTION_LEN - 2  # every caption ended
    tokens, scores = pred.caption_device(torch.from_numpy(pre_u8), torch.from_numpy(post_u8))
    assert tokens.shape == (4, cd.MAX_CAPTION_LEN) and scores.shape == (4,)
    assert cd.beam_search_decode.steps < cd.MAX_CAPTION_LEN - 1  # every beam retired early
