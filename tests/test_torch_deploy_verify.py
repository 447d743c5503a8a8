"""``checkpoint/verify.py`` and ``cli verify-checkpoint --device cpu`` of the
port against the JAX harness: the per-block activations of the TINY X3D
agree with JAX ``capture_block_activations`` within 1e-5 of each block's
largest value, and on a synthetic full X3D-L ``X3D_L.pyth`` with a trace
from ``tools/record_torch_trace.py`` both CLIs pass the matching file (exit
0), fail a perturbed one (exit 1, stem and stage 1 still passing), report
statistics without a trace, and refuse a probe mismatch."""

import json

import numpy as np
import pytest
import torch

from change3d_tpu.checkpoint.convert import load_x3d_pretrained as jax_load_x3d
from change3d_tpu.checkpoint.verify import (
    capture_block_activations as jax_capture,
    fixed_probe_input as jax_probe,
)
from change3d_tpu.cli import main as jax_cli
from change3d_tpu_torch import cli
from change3d_tpu_torch.checkpoint.convert import load_x3d_pretrained
from change3d_tpu_torch.checkpoint.verify import (
    BLOCK_NAMES,
    capture_block_activations,
    fixed_probe_input,
)
from change3d_tpu_torch.models.x3d import X3DConfig

from tests.test_convert_reference import TINY_CFG
from tests.torch_oracle import make_random_x3d_state_dict
from tools.record_torch_trace import record_trace

HW = 32
PCFG = X3DConfig(stem_dim_out=TINY_CFG.stem_dim_out, stage_dims=TINY_CFG.stage_dims,
                 stage_inner_dims=TINY_CFG.stage_inner_dims, stage_depths=TINY_CFG.stage_depths)


def test_probe_is_the_jax_probe():
    np.testing.assert_array_equal(fixed_probe_input(3, 16, 24, 5), jax_probe(3, 16, 24, 5))


def test_block_activations_match_jax(tmp_path):
    path = str(tmp_path / "tiny.pyth")
    torch.save({"model_state": make_random_x3d_state_dict(TINY_CFG, seed=2)}, path)
    x = fixed_probe_input(3, HW, HW, 1)
    want = jax_capture(jax_load_x3d(path, TINY_CFG), TINY_CFG, x)
    got = capture_block_activations(load_x3d_pretrained(path, PCFG), PCFG, x, device="cpu")
    assert set(got) == set(want) == set(BLOCK_NAMES) | {"head_logits"}
    for name, w in want.items():
        w = np.asarray(w)
        assert got[name].shape == w.shape
        err = np.abs(got[name] - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (name, err, np.abs(w).max())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A synthetic full X3D-L .pyth, its trace, and a copy with one stage-2
    weight perturbed."""
    root = tmp_path_factory.mktemp("ckpt")
    sd = make_random_x3d_state_dict(seed=3)
    good, bad, trace = str(root / "X3D_L.pyth"), str(root / "bad.pyth"), str(root / "acts.npz")
    torch.save({"model_state": sd, "epoch": 0}, good)
    np.savez_compressed(trace, **record_trace(sd, t=3, h=HW, w=HW))
    key = "blocks.2.res_blocks.0.branch2.conv_b.weight"
    torch.save({"model_state": {**sd, key: sd[key] + 0.05}}, bad)
    return good, bad, trace


def _verify(path, trace, *extra):
    args = ["verify-checkpoint", "--pretrained", path, "--height", str(HW), "--width", str(HW),
            *extra]
    return args + (["--trace", trace] if trace else [])


def test_cli_passes_a_matching_trace_as_jax_does(files, tmp_path, capsys):
    good, _, trace = files
    report_path = str(tmp_path / "report.json")
    # Random weights amplify activations to about 1e11 by stage 4, so fp32
    # reduction-order noise needs the JAX test's rtol of 1e-2.
    rc = cli.main(_verify(good, trace, "--rtol", "1e-2", "--report", report_path,
                          "--device", "cpu"))
    out = capsys.readouterr().out
    assert rc == 0 and "parity vs trace: PASS" in out
    with open(report_path) as f:
        report = json.load(f)
    assert report["all_pass"] is True and report["strict_load"] is True
    assert set(report["blocks"]) == set(BLOCK_NAMES) | {"head_logits"}
    assert jax_cli(_verify(good, trace, "--rtol", "1e-2")) == rc


def test_cli_fails_perturbed_weights_as_jax_does(files, capsys):
    _, bad, trace = files
    rc = cli.main(_verify(bad, trace, "--device", "cpu"))
    out = capsys.readouterr().out
    assert rc == 1 and "parity vs trace: FAIL" in out
    rows = {line.split()[0]: line for line in out.splitlines() if line.startswith("  block")}
    assert "PASS" in rows["block0_stem"] and "PASS" in rows["block1_stage1"]
    assert "FAIL" in rows["block2_stage2"]
    assert jax_cli(_verify(bad, trace)) == rc


def test_cli_without_trace_reports_statistics(files, capsys):
    good, _, _ = files
    assert cli.main(_verify(good, None, "--device", "cpu")) == 0
    out = capsys.readouterr().out
    assert "no trace given" in out and "strict conversion: OK" in out
    assert all(name in out for name in BLOCK_NAMES)


def test_cli_refuses_a_probe_mismatch_and_defaults_to_the_card(files):
    good, _, trace = files
    with pytest.raises(ValueError, match="probe"):
        cli.main(["verify-checkpoint", "--pretrained", good, "--trace", trace, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(_verify(good, None))
