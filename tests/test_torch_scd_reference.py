"""The port's SCD model against the benchmark's plain fp32 SCD reference
(``benchmark/reference/change3d_scd.py``, which imports nothing of the port
and nothing of JAX) on seeded weights at a small size (32x32, X3D-L widths,
depths 2, 2, 3, 2): the fp32 forward's three heads, the bf16
``Predictor.predict_u8`` decisions, ``Change3D.heads(encoder(...))`` equal
to the forward for every detection task, and the spans that split
``c3d.predict.forward`` into the encoder and the heads."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.benchlib import inputs, program
from benchmark.benchlib.compare import mask_checks
from benchmark.benchlib.manifest import ROOT, load_module
from benchmark.reference.change3d import normalize_u8
from benchmark.reference.change3d_scd import ScdRef, make_params
from change3d_tpu_torch.inference import Predictor
from tests._torch_parallel import make_model

SIZE, SEED = 32, 2 ** 31 + 29
# The port's fp32 forward and the reference sum the same products in
# another order (channels-last kernels against channel-first convs): at this
# size they agree to ~1e-6 in logit; 1e-4 leaves room for other CPUs' BLAS.
FP32_ATOL = 1e-4
# bf16 activations round every op by up to 2^-9 of its value, so a served
# decision may differ from the reference's where its logits lie within a
# few hundredths: sound bf16 runs read 0.012-0.021 here, the fp8 control
# 0.13-0.24 (both on the benchmark's pairs at 32 and 64 pixels).
BF16_GAP = 0.06


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scd():
    with open(os.path.join(ROOT, "benchmark", "configs", "change3d-scd-x3dl.json")) as f:
        cfg = json.load(f)
    cfg.update(image_size=SIZE, stage_depths=[2, 2, 3, 2])
    params = make_params(cfg, SEED, "cpu")
    model = program.build_model(cfg, params, "cpu").eval()
    pre, post, _ = inputs.image_pairs(SEED, 4, SIZE)
    with torch.no_grad():
        z = ScdRef(cfg, params).head_logits(normalize_u8(torch.from_numpy(pre), "scd"),
                                            normalize_u8(torch.from_numpy(post), "scd"))
    return cfg, params, model, pre, post, z


def test_fp32_heads_match_the_reference(scd):
    _, _, model, pre, post, z = scd
    with torch.no_grad():
        out = model(normalize_u8(torch.from_numpy(pre), "scd"),
                    normalize_u8(torch.from_numpy(post), "scd"))
    assert set(out) == {"pre", "post", "change"}
    torch.testing.assert_close(out["pre"], z["pre"], atol=FP32_ATOL, rtol=0)
    torch.testing.assert_close(out["post"], z["post"], atol=FP32_ATOL, rtol=0)
    # The change head ends in its sigmoid, whose slope is at most 1/4.
    torch.testing.assert_close(out["change"][..., 0], torch.sigmoid(z["change"]),
                               atol=FP32_ATOL / 4, rtol=0)


def test_bf16_predict_u8_decisions_match_the_reference(scd):
    cfg, params, _, pre, post, z = scd
    model = program.build_model(cfg, params, "cpu")
    served = Predictor(model, compute_dtype=torch.bfloat16, device="cpu").predict_u8(pre, post)
    assert served["pre"].dtype == served["post"].dtype == np.uint8
    assert served["change"].dtype == bool and served["change"].shape == (4, SIZE, SIZE)
    class_gap = load_module("drivers", "closed_predict_scd").class_gap
    ids = np.arange(4)
    for key in ("pre", "post"):
        assert class_gap([(ids, served[key])], z[key]) <= BF16_GAP
    mask, _ = mask_checks([(ids, served["change"])], z["change"].numpy(),
                          {"mask_gap_logit": BF16_GAP})
    assert mask.ok, mask


@pytest.mark.parametrize("task", ["bcd", "scd", "bda"])
def test_heads_of_the_encoder_are_the_forward(task):
    model = make_model(task).eval()
    rs = np.random.RandomState(3)
    pre, post = (torch.from_numpy(rs.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32))
                 for _ in range(2))
    with torch.no_grad():
        whole, split = model(pre, post), model.heads(model.encoder(pre, post))
    assert whole.keys() == split.keys()
    for key in whole:
        assert torch.equal(whole[key], split[key]), key


def _spans(prof):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("c3d.")]


def test_encode_and_heads_spans_lie_in_the_forward_span(scd):
    cfg, params, model, pre, post, _ = scd
    pred = Predictor(model, compute_dtype=torch.float32, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pred.predict_u8(pre, post)
    spans = _spans(prof)
    named = lambda n: [s for s in spans if s[0] == n]
    (forward,), (encode,), (heads,) = (named(f"c3d.predict.{n}")
                                       for n in ("forward", "encode", "heads"))
    for part in (encode, heads):
        assert forward[1] <= part[1] and part[2] <= forward[2]
    assert encode[2] <= heads[1]
    # The model's own forward holds no span.
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        model(normalize_u8(torch.from_numpy(pre), "scd"), normalize_u8(torch.from_numpy(post),
                                                                       "scd"))
    assert _spans(prof) == []
