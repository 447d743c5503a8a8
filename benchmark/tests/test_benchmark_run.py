"""Whole runs of each cell on the CPU at a small size, with the card check
skipped: the result line's keys, the check lines, no process left behind,
the JAX guard, and a run
broken underneath (each fault a cell can have) or replaced by its
lower-precision control coming out not correct."""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.benchlib import runner
from benchmark.benchlib.manifest import ROOT
from benchmark.tests.conftest import small_cell

SEED = 2 ** 31 + 17
CELLS = ["bcd-predict-b16", "cc-caption-b16", "bcd-serve-poisson"]


def _run(cell, seconds=1.0):
    return runner.run(cell.name, SEED, seconds, False, time.perf_counter(), device="cpu",
                      cell=cell)


def _children() -> list:
    """Processes whose parent is this one (``ps`` itself left out)."""
    ps = subprocess.Popen(["ps", "-o", "pid=,cmd=", "--ppid", str(os.getpid())],
                          stdout=subprocess.PIPE, text=True)
    out = ps.communicate(timeout=30)[0].splitlines()
    return [line for line in out if int(line.split()[0]) != ps.pid]


def _patched(cell, patch, **kw):
    """``cell`` whose driver applies ``patch(driver)`` after its set-up."""
    base = cell.driver().Driver

    class Broken(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **kw, **k)
            patch(self)

    cell.driver = lambda: SimpleNamespace(Driver=Broken)
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_a_run_prints_its_keys_and_is_correct(name, capsys):
    cell = small_cell(name)
    result = _run(cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    err = capsys.readouterr().err.strip().splitlines()
    checks = err[-len(result["checks"]):]
    assert all(line.startswith("check ") and " limit " in line for line in checks)
    json.dumps(result)
    # Every process the run started has ended (the serving cell's load
    # generator and the resource tracker its spawn starts).
    assert _children() == []


def test_no_card_means_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "bcd-predict-b16",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_jax_in_sys_modules_means_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "change3d_tpu.fake", SimpleNamespace())
    assert runner.forbidden_modules() == ["change3d_tpu"]
    assert _run(small_cell("bcd-predict-b16")) is None
    monkeypatch.delitem(sys.modules, "change3d_tpu.fake")
    # The port's name begins with the JAX package's; whole names are compared.
    assert "change3d_tpu_torch" in {m.split(".")[0] for m in sys.modules}
    assert runner.forbidden_modules() == []


def _wrap(obj, attr, after):
    fn = getattr(obj, attr)
    setattr(obj, attr, lambda *a, **k: after(fn(*a, **k)))


def _flip_block(out):
    out["change"][0, :8, :8] ^= True
    return out


def _half_masks(out):
    m = out["change"]
    m[len(m) // 2:] = m[:len(m) - len(m) // 2]
    return out


def _alter_token(out):
    tokens, scores = out
    tokens = tokens.clone()
    tokens[0, 3] = (tokens[0, 3] + 1) % 500
    return tokens, scores


def _flip_served(driver):
    batcher = driver.service._batcher
    finalize = batcher._finalize

    def altered(handle):
        out = finalize(handle)
        out["change"][0, :8, :8] ^= True
        return out

    batcher._finalize = altered


FAULTS = {
    "predict_answer_altered": ("bcd-predict-b16",
                               lambda d: _wrap(d.predictor, "predict_u8", _flip_block), {}),
    "predict_half_batch": ("bcd-predict-b16",
                           lambda d: _wrap(d.predictor, "predict_u8", _half_masks), {}),
    "caption_token_altered": ("cc-caption-b16",
                              lambda d: _wrap(d.predictor, "decode", _alter_token), {}),
    "serve_answer_altered": ("bcd-serve-poisson", _flip_served, {}),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    name, patch, kw = FAULTS[fault]
    result = _run(_patched(small_cell(name), patch, **kw))
    assert result["correct"] is False, result["checks"]


CONTROLS = [("bcd-predict-b16", "fp8"), ("cc-caption-b16", "fp8"), ("bcd-serve-poisson", "fp8")]


@pytest.mark.parametrize("name,variant", CONTROLS)
def test_the_lower_precision_control_is_not_correct(name, variant):
    cell = small_cell(name, size=64)
    result = _run(_patched(cell, lambda d: None, variant=variant))
    assert result["correct"] is False, result["checks"]
    assert np.isfinite([c["value"] for c in result["checks"].values()]).all()
