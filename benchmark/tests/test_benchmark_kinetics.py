"""The Kinetics cell (``x3dl-classify-v30``) on the CPU at a small size (X3D-L
widths, depths 1, 2, 2, 2, 16 frames at 64^2): a whole run prints its keys
and is correct; a run broken underneath (logits of the wrong clips, a class
moved, a row missing) or replaced by its fp8 control is not; and the work
counted from shapes (``work/kinetics.py``) equals torch's FlopCounterMode
over the reference, at the convs' own sizes."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.benchlib.manifest import Cell
from benchmark.reference.x3d_kinetics import KineticsRef, make_params
from benchmark.tests.test_benchmark_run import _children, _patched, _run, _wrap
from benchmark.work import flops, kinetics

NAME = "x3dl-classify-v30"


def small_cell(crop: int = 64) -> Cell:
    cell = Cell(NAME)
    cell.config.update(crop=crop, stage_depths=[1, 2, 2, 2])
    cell.traffic.update(batch=3, pool=6, batches=2)
    return cell


def test_a_run_prints_its_keys_and_is_correct(capsys):
    result = _run(small_cell())
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "infer_samples_per_s"}
    assert list(result["checks"]) == ["logit_gap", "top1_gap", "answers_missing"]
    err = capsys.readouterr().err.strip().splitlines()
    assert all(line.startswith("check ") for line in err[-3:])
    assert _children() == []


def _rolled(out):
    return np.roll(out, 1, axis=0)


def _class_moved(out):
    out = out.copy()
    out[0] = np.roll(out[0], 1)
    return out


def _row_missing(out):
    return out[1:]


def _not_finite(out):
    out = out.copy()
    out[0, 0] = np.nan
    return out


FAULTS = {"clips_swapped": (_rolled, "logit_gap"), "class_moved": (_class_moved, "logit_gap"),
          "row_missing": (_row_missing, "answers_missing"),
          "nan": (_not_finite, "answers_missing")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    alter, check = FAULTS[fault]
    cell = _patched(small_cell(), lambda d: _wrap(d.classifier, "classify_u8", alter))
    result = _run(cell)
    assert result["correct"] is False
    c = result["checks"][check]
    assert c["value"] > c["limit"], result["checks"]


def test_the_fp8_control_is_not_correct():
    result = _run(_patched(small_cell(), lambda d: None, variant="fp8"))
    assert result["correct"] is False, result["checks"]
    assert np.isfinite([c["value"] for c in result["checks"].values()]).all()


@pytest.mark.parametrize("crop", [76, 64])
def test_kinetics_flops_match_the_counter(crop):
    cfg = small_cell(crop).config
    ref = KineticsRef(cfg, make_params(cfg, 5, "cpu"))
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        ref.logits(torch.zeros(1, cfg["frames"], crop, crop, 3))
    assert float(counter.get_total_flops()) == kinetics.clip_flops(cfg)


def test_the_published_shapes_and_their_bound():
    cfg = Cell(NAME).config
    sizes = [b.h for b, _ in kinetics.blocks(cfg)]
    # 312 -> 156 (stem) -> 78 -> 39 -> 20 -> 10, the conv's own ceil(n / 2).
    assert sorted(set(sizes), reverse=True) == [78, 39, 20, 10]
    fused = kinetics.fused_blocks(cfg)
    assert len(fused) == 51 and {b.t for b in fused} == {16}
    assert kinetics.clip_flops(cfg) == pytest.approx(36.8e9, rel=0.01)
    # Stage 1's fused block at B = 30 is bound by its fp32 taps.
    least = flops.fused_block_least_s(fused[0], 30)
    assert max(least, key=least.get) == "fp32"
    assert kinetics.fused_least_s(cfg, 30) == pytest.approx(2.12e-3, rel=0.01)
