"""X3D-L as a Kinetics-400 classifier on the port's normal path
(``x3d_classifier("l")``, ``inference.ClipClassifier``, ``cli classify``),
held against the benchmark's plain fp32 reference
(``benchmark/reference/x3d_kinetics.py``, which imports nothing of the port
and nothing of JAX) on seeded weights at X3D-L's widths with depths cut to
(1, 2, 2, 2): 16-frame clips at 76^2, so the stage sizes 38 -> 19 -> 10 ->
5 -> 3 are odd and stages 3 and 4 take T-tiles (the fused blocks through
their plain versions on the CPU). The kernels' plans at 16 x 312^2 are
pinned in tests/test_torch_fused_plan.py and test_torch_depthwise_plan.py."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.benchlib.manifest import ROOT
from benchmark.drivers.closed_classify import build_classifier, clips
from benchmark.reference.x3d_kinetics import KineticsRef, make_params, normalize_u8, param_spec
from change3d_tpu_torch import cli
from change3d_tpu_torch.checkpoint.convert import x3d_torch_key_map
from change3d_tpu_torch.inference import ClipClassifier
from change3d_tpu_torch.models import x3d

CROP, FRAMES, DEPTHS, SEED = 76, 16, (1, 2, 2, 2), 2 ** 31 + 41
# The port's fp32 forward sums the reference's products in another order
# (channels-last kernels and matmuls against channel-first convs): they
# agree to ~5e-7 of the largest logit here; 1e-4 leaves room for other
# CPUs' BLAS.
FP32_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _config(**cut) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", "x3d-l-kinetics400.json")) as f:
        return dict(json.load(f), **cut)


@pytest.fixture(scope="module")
def small():
    cfg = _config(crop=CROP, stage_depths=list(DEPTHS))
    params = make_params(cfg, SEED, "cpu")
    pool = clips(SEED, 3, FRAMES, CROP)
    with torch.no_grad():
        z = KineticsRef(cfg, params).logits(normalize_u8(torch.from_numpy(pool)))
    return cfg, params, pool, z


def test_the_configuration_is_the_port_s_x3d_l_classifier():
    cfg = _config()
    model = x3d.x3d_classifier("l", device="cpu", seed=1)
    want = model.cfg
    assert want == dataclasses.replace(x3d.x3d_l_config(), stem_conv_stride=(1, 2, 2))
    assert (cfg["stem_dim"], tuple(cfg["stage_dims"]), tuple(cfg["stage_inner_dims"]),
            tuple(cfg["stage_depths"]), tuple(cfg["stem_stride"]), cfg["head_dim_out"],
            cfg["num_classes"]) == (want.stem_dim_out, want.stage_dims, want.stage_inner_dims,
                                    want.stage_depths, want.stem_conv_stride, want.head_dim_out,
                                    want.num_classes)
    # X3D-L's published 6.15 M parameters; the reference names every entry.
    assert sum(p.numel() for p in model.parameters()) == 6_153_384
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        name: shape for name, shape, _ in param_spec(cfg)}
    with pytest.raises(ValueError, match="'m' or 'l'"):
        x3d.x3d_classifier("xl", device="cpu")


def test_fp32_logits_match_the_reference(small):
    cfg, params, pool, z = small
    model = build_classifier(cfg, params, "cpu")
    got = ClipClassifier(model, compute_dtype=torch.float32, device="cpu").classify_u8(pool)
    assert got.dtype == np.float32 and got.shape == (3, 400)
    torch.testing.assert_close(torch.from_numpy(got), z, rtol=FP32_RTOL,
                               atol=FP32_RTOL * float(z.abs().max()))
    # Logits that spread over the classes and differ between clips.
    assert float(z.std(-1).min()) > 0.05 and float(z.std(0).mean()) > 1e-3


def test_normalisation_and_the_two_halves_are_the_forward(small):
    cfg, params, pool, _ = small
    model = build_classifier(cfg, params, "cpu").eval()
    clf = ClipClassifier(model, compute_dtype=torch.float32, device="cpu")
    u8 = torch.from_numpy(pool)
    assert torch.equal(clf.normalize(u8), normalize_u8(u8))
    with torch.no_grad():
        whole = model(normalize_u8(u8), classify=True)
    assert torch.equal(clf.logits_device(u8), whole)


def test_bf16_logits_stay_near_the_reference(small):
    """bf16 rounds every activation by up to 2^-9 of its value: here the
    served logits lie within 0.02-0.03 of a clip's logit spread of the
    reference's, and fp8 products (the cell's control) 0.2-0.27."""
    cfg, params, pool, z = small
    model = build_classifier(cfg, params, "cpu")
    got = ClipClassifier(model, device="cpu").classify_u8(pool)
    gap = (np.abs(got - z.numpy()) / z.numpy().std(-1, keepdims=True)).max()
    assert gap < 0.08, gap


def _spans(prof):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("c3d.")]


def test_classify_spans_nest_in_order(small):
    cfg, params, pool, _ = small
    model = build_classifier(cfg, params, "cpu")
    clf = ClipClassifier(model, compute_dtype=torch.float32, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        clf.classify_u8(pool[:1])
    spans = {n: (s, e) for n, s, e in _spans(prof)}
    assert set(spans) == {f"c3d.classify{p}" for p in
                          ("", ".h2d", ".forward", ".encode", ".head", ".d2h")}
    outer, fwd = spans["c3d.classify"], spans["c3d.classify.forward"]
    assert outer[0] <= spans["c3d.classify.h2d"][0] and spans["c3d.classify.d2h"][1] <= outer[1]
    assert spans["c3d.classify.h2d"][1] <= fwd[0] and fwd[1] <= spans["c3d.classify.d2h"][0]
    for part in ("encode", "head"):
        s, e = spans[f"c3d.classify.{part}"]
        assert fwd[0] <= s and e <= fwd[1]
    assert spans["c3d.classify.encode"][1] <= spans["c3d.classify.head"][0]
    with pytest.raises(ValueError, match="uint8"):
        clf.classify_u8(pool.astype(np.float32))
    with pytest.raises(ValueError, match="Kinetics head"):
        ClipClassifier(x3d.X3D(x3d.X3DConfig(stage_depths=DEPTHS)), device="cpu")


def _kinetics_file(model: x3d.X3D, path: str) -> None:
    """``model``'s weights as a pytorchvideo-named Kinetics file, the
    inverse of ``convert_x3d_state_dict``."""
    port = model.state_dict()
    sd = {}
    for key, (port_key, kind) in x3d_torch_key_map(model.cfg).items():
        v = torch.tensor(0) if kind == "skip" else port[port_key]
        if kind in ("dense", "pointwise"):
            v = v.t() if kind == "dense" else v.t()[:, :, None, None, None]
        sd[key] = v.contiguous()
    torch.save({"model_state": sd}, path)


def test_cli_classify_averages_each_video_s_views(small, tmp_path, monkeypatch):
    cfg, params, pool, _ = small
    real = x3d.x3d_l_config
    monkeypatch.setattr(x3d, "x3d_l_config",
                        lambda **kw: dataclasses.replace(real(**kw), stage_depths=DEPTHS))
    model = build_classifier(cfg, params, "cpu")
    _kinetics_file(model, str(tmp_path / "X3D_L.pyth"))
    videos = np.concatenate([pool, pool[::-1]])  # 2 videos of 3 views
    np.save(tmp_path / "clips.npy", videos)
    argv = ["classify", "--clips", str(tmp_path / "clips.npy"), "--out",
            str(tmp_path / "top5.json"), "--views", "3", "--device", "cpu",
            "--compute_dtype", "float32"]
    assert cli.main(argv + ["--pretrained", str(tmp_path / "X3D_L.pyth")]) == 0
    with open(tmp_path / "top5.json") as f:
        got = json.load(f)
    logits = ClipClassifier(model, compute_dtype=torch.float32, device="cpu").classify_u8(pool)
    probs = torch.softmax(torch.from_numpy(logits), -1).mean(0)
    want = torch.argsort(probs, descending=True, stable=True)[:5].tolist()
    assert [v["video"] for v in got] == [0, 1]
    for video in got:  # the same views in another order: the same average
        assert [c["class"] for c in video["top5"]] == want
        np.testing.assert_allclose([c["prob"] for c in video["top5"]], probs[want].numpy(),
                                   rtol=1e-5)
    with pytest.raises(SystemExit, match="videos of 4 views"):
        cli.main(argv[:5] + ["--views", "4", "--device", "cpu"])
