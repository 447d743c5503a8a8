"""A sharded predictor on the CPU (``devices=["cpu", "cpu"]``: one replica
per device, each batch split into equal slices and gathered in order)
against the single-device predictor on the same TINY models: BCD masks and
probabilities (float and uint8 paths), SCD and BDA class maps, CC captions;
its refusal of a batch that does not split. ``PredictService`` keeps and
refuses batch buckets by the predictor's ``batch_divisor`` as the JAX
service does, and ``cli serve --shard --artifact`` is refused with the JAX
CLI's reason."""

import argparse
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from change3d_tpu import cli as jax_cli
from change3d_tpu import serving as jax_serving
from change3d_tpu_torch import cli
from change3d_tpu_torch.inference import CaptionPredictor, Predictor
from change3d_tpu_torch.serving import PredictService

from tests import _torch_parallel as tp
from tests._torch_parallel import few_threads  # noqa: F401 (autouse)

CPU2 = ["cpu", "cpu"]


def _pairs(n, seed=0, u8=False):
    rs = np.random.RandomState(seed)
    if u8:
        return tuple(rs.randint(0, 256, (n, tp.HW, tp.HW, 3)).astype(np.uint8) for _ in range(2))
    return tuple(rs.randn(n, tp.HW, tp.HW, 3).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("task", ["bcd", "scd", "bda"])
def test_sharded_predictor_equals_one_device(task):
    one = Predictor(tp.make_model(task), compute_dtype=torch.float32, device="cpu")
    two = Predictor(tp.make_model(task), compute_dtype=torch.float32, devices=CPU2)
    assert (one.batch_divisor, two.batch_divisor) == (1, 2)
    assert len(two.replicas) == 2 and two.replicas[1] is not two.model
    pre, post = _pairs(4)
    want, got = one.predict_probs(pre, post), two.predict_probs(pre, post)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6, err_msg=key)
    for key, mask in one.predict(pre, post).items():
        np.testing.assert_array_equal(two.predict(pre, post)[key], mask, err_msg=key)
    pre, post = _pairs(4, u8=True)
    launch = two.predict_u8_async(pre, post)
    assert launch.event is None and launch.more_events == ()
    want = one.predict_u8(pre, post)
    for key, got in two.finalize_u8(launch).items():
        np.testing.assert_array_equal(got, want[key], err_msg=key)


def test_sharded_caption_predictor_equals_one_device():
    word_map = {"<pad>": 0, "<unk>": 1, "<start>": 2, "<end>": 3,
                **{f"w{i}": 4 + i for i in range(7)}}
    kw = dict(word_map=word_map, beam_size=2, compute_dtype=torch.float32)
    one = CaptionPredictor(tp.make_model("cc", dropout=0.0), device="cpu", **kw)
    two = CaptionPredictor(tp.make_model("cc", dropout=0.0), devices=CPU2, **kw)
    pre, post = _pairs(4, seed=1)
    assert two.caption(pre, post) == one.caption(pre, post)
    pre, post = _pairs(4, seed=2, u8=True)
    assert two.caption_u8(pre, post) == one.caption_u8(pre, post)


def test_a_batch_that_does_not_split_is_refused():
    two = Predictor(tp.make_model("bcd"), devices=CPU2)
    with pytest.raises(ValueError, match="batch 3 does not split over the predictor's 2"):
        two.predict(*_pairs(3))


def _stub(divisor):
    return SimpleNamespace(batch_divisor=divisor, model=SimpleNamespace(in_height=16, in_width=16),
                           predict=lambda pre, post: {})


@pytest.mark.parametrize("divisor,batch_size,buckets", [
    (2, 16, None), (4, 16, None), (4, 8, None), (3, 12, None), (2, 8, "2,5,8"), (1, 16, None)])
def test_service_buckets_follow_the_jax_service(divisor, batch_size, buckets, capsys):
    kw = dict(batch_size=batch_size, max_delay_ms=1,
              buckets=tuple(int(b) for b in buckets.split(",")) if buckets else None)
    ours = PredictService("bcd", _stub(divisor), **kw)
    theirs = jax_serving.PredictService("bcd", _stub(divisor), **kw)
    try:
        assert ours.buckets == theirs.buckets
        assert all(b % divisor == 0 for b in ours.buckets) and ours.buckets[-1] == batch_size
    finally:
        ours.close()
        theirs.close()
    printed = capsys.readouterr().out.splitlines()
    dropped = [line for line in printed if line.startswith("[serving] dropping")]
    assert len(dropped) in (0, 2) and len(set(dropped)) <= 1


def test_service_refuses_a_batch_that_does_not_split():
    for service in (PredictService, jax_serving.PredictService):
        with pytest.raises(ValueError) as e:
            service("bcd", _stub(4), batch_size=6)
        assert str(e.value) == ("batch_size 6 must be divisible by the sharded predictor's "
                                "device count (4)")


def test_serve_shard_artifact_is_refused_with_the_jax_reason(capsys):
    with pytest.raises(SystemExit) as ours:
        cli.main(["serve", "--model_task", "bcd", "--artifact", "x.pt2", "--shard", "--device",
                  "cpu"])
    with pytest.raises(SystemExit) as theirs:
        jax_cli.run_serve(argparse.Namespace(shard=True, artifact="x.pt2"))
    assert str(ours.value) == str(theirs.value)
    assert "--shard applies to checkpoint-backed serving" in str(ours.value)
