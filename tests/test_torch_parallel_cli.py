"""``python -m change3d_tpu_torch.cli bcd --device cpu --num_processes 2``
(two gloo processes, the TINY model, a global batch of 8 on 16 train and 5
test pairs at 16²) against the same command in one process:

- both processes return the one-process report, and only process 0 writes
  the log and the checkpoints;
- ``CHANGE3D_PREEMPT_AFTER_STEP=1`` on process 1 alone stops both after
  step 1 with one checkpoint;
- ``--resume`` restores that checkpoint on both and ends bit-for-bit where
  the uninterrupted two-process run ends."""

import json
import os

import numpy as np
import pytest
import torch

from change3d_tpu_torch import cli
from change3d_tpu_torch.data.png import write_png
from change3d_tpu_torch.train import loop

from tests import _torch_parallel as tp
from tests._torch_parallel import few_threads  # noqa: F401 (autouse)

HW = 16


def _write_levir(root):
    rs = np.random.RandomState(0)
    for split, n in (("train", 16), ("test", 5)):
        for d in ("t1", "t2", "label"):
            os.makedirs(os.path.join(root, split, d))
        for i in range(n):
            pre = rs.randint(0, 256, (HW, HW, 3)).astype(np.uint8)
            post = pre.copy()
            post[4:10, 3:12] = rs.randint(0, 256, (6, 9, 3))
            label = np.zeros((HW, HW), np.uint8)
            label[4:10, 3:12] = 255
            write_png(os.path.join(root, split, "t1", f"{i:03d}.png"), pre)
            write_png(os.path.join(root, split, "t2", f"{i:03d}.png"), post)
            write_png(os.path.join(root, split, "label", f"{i:03d}.png"), label)


def _argv(root, save_dir, *extra):
    return ["bcd", "--file_root", root, "--save_dir", save_dir, "--device", "cpu",
            "--in_height", str(HW), "--in_width", str(HW), "--batch_size", "8",
            "--num_workers", "1", "--max_epochs", "2", "--compute_dtype", "float32",
            "--lr", "1e-3", *extra]


def _run_dir(save_dir):
    return os.path.join(save_dir, "LEVIR-CD_iter_80000_lr_0.001")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    root, out = str(tmp / "data"), str(tmp / "out")
    _write_levir(root)
    os.makedirs(out)
    saves = {name: str(tmp / name) for name in ("one", "full", "pre")}
    procs = tp.start_ranks(tp.cli_worker, 2, [
        ("full", _argv(root, saves["full"]), 0),
        ("pre", _argv(root, saves["pre"]), 1),
        ("resumed", _argv(root, saves["pre"], "--resume"), 0),
    ], out)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "build_model", tp.tiny_build_model)
        mp.delenv("CHANGE3D_PREEMPT_AFTER_STEP", raising=False)
        one = cli.main(_argv(root, saves["one"]))
    tp.join_ok(procs, timeout=120)
    results = {}
    for name in ("full", "pre", "resumed"):
        for r in range(2):
            with open(os.path.join(out, f"{name}-{r}.json")) as f:
                results[name, r] = json.load(f)
    return one, results, saves


def test_both_processes_report_the_one_process_run(runs):
    one, results, _ = runs
    assert results["full", 0] == results["full", 1]
    got = results["full", 0]
    assert got["steps"] == one["steps"] == 4
    for split in ("last", "test_best"):
        assert set(got[split]) == set(one[split])
        for key, want in one[split].items():
            np.testing.assert_allclose(got[split][key], want, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{split} {key}")


def test_process_zero_alone_writes_the_run(runs):
    run = _run_dir(runs[2]["full"])
    with open(os.path.join(run, "train_val_log.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    assert [r["event"] for r in rows].count("config") == 1
    assert [(r["epoch"], r["split"]) for r in rows if r["event"] == "epoch"] == [
        (1, "val"), (-1, "test_best")]
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["4", "train_meta.json"]
    assert os.path.exists(os.path.join(run, "best", "model.pt"))
    assert not [f for _, _, files in os.walk(run) for f in files if f.endswith(".tmp")]


def test_sigterm_on_one_process_stops_both_after_the_same_step(runs):
    _, results, saves = runs
    for r in range(2):
        assert results["pre", r] == {"resumed_from_step": 0, "preempted_at_step": 1}
    run = _run_dir(saves["pre"])
    assert os.path.exists(os.path.join(run, "ckpt", "1", "state.pt"))


def _bit_identical(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bit_identical(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_bit_identical(x, y) for x, y in zip(a, b))
    return a == b


def test_resume_restores_both_processes_bit_for_bit(runs):
    _, results, saves = runs
    assert results["resumed", 0] == results["resumed", 1]
    assert results["resumed", 0]["resumed_from_step"] == 1
    assert results["resumed", 0]["test_best"] == results["full", 0]["test_best"]
    final = [torch.load(os.path.join(_run_dir(saves[k]), "ckpt", "4", "state.pt"))
             for k in ("full", "pre")]
    assert _bit_identical(final[0], final[1])
