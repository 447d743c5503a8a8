"""The SCD cell (``scd-predict-b16``) on the CPU at a small size: a whole run
prints its keys and is correct; a run broken underneath (the pre and post
maps swapped, a class map shifted by one class, the change mask inverted)
or replaced by its fp8 control is not; and the work counted from shapes
(``work/scd.py``) equals torch's FlopCounterMode over the reference."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.benchlib.manifest import Cell
from benchmark.reference.change3d_scd import ScdRef, make_params
from benchmark.tests.conftest import small_cell
from benchmark.tests.test_benchmark_run import _children, _patched, _run, _wrap
from benchmark.work import flops
from benchmark.work.scd import scd_flops

NAME = "scd-predict-b16"


def test_a_run_prints_its_keys_and_is_correct(capsys):
    cell = small_cell(NAME)
    result = _run(cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "infer_samples_per_s"}
    assert list(result["checks"]) == ["mask_gap_logit", "class_gap_logit", "answers_missing"]
    err = capsys.readouterr().err.strip().splitlines()
    assert all(line.startswith("check ") for line in err[-3:])
    assert _children() == []


def _swap_pre_post(out):
    out["pre"], out["post"] = out["post"], out["pre"]
    return out


def _shift_class(out):
    out["post"] = ((out["post"].astype(np.int64) + 1) % 6).astype(np.uint8)
    return out


def _invert_change(out):
    out["change"] = ~out["change"]
    return out


def _drop_map(out):
    del out["pre"]
    return out


FAULTS = {"pre_post_swapped": (_swap_pre_post, "class_gap_logit"),
          "class_shifted": (_shift_class, "class_gap_logit"),
          "change_inverted": (_invert_change, "mask_gap_logit"),
          "map_missing": (_drop_map, "answers_missing")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    alter, check = FAULTS[fault]
    cell = _patched(small_cell(NAME), lambda d: _wrap(d.predictor, "predict_u8", alter))
    result = _run(cell)
    assert result["correct"] is False
    c = result["checks"][check]
    assert c["value"] > c["limit"], result["checks"]


def test_the_fp8_control_is_not_correct():
    result = _run(_patched(small_cell(NAME, size=64), lambda d: None, variant="fp8"))
    assert result["correct"] is False, result["checks"]
    assert np.isfinite([c["value"] for c in result["checks"].values()]).all()


@pytest.mark.parametrize("size", [32, 64])
def test_scd_flops_match_the_counter(size):
    cfg = Cell(NAME).config
    cfg.update(image_size=size)
    ref = ScdRef(cfg, make_params(cfg, 5, "cpu"))
    x = torch.zeros(1, size, size, 3)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        ref.head_logits(x, x)
    assert float(counter.get_total_flops()) == scd_flops(cfg)
    # 37 fused blocks at T = 5.
    assert {b.t for b in flops.fused_blocks(cfg)} == {5} and len(flops.fused_blocks(cfg)) == 37
