"""``python -m change3d_tpu_torch.cli bcd --device cpu`` end to end on a tiny
synthetic dataset written with data/png.py, with the TINY backbone: logs,
checkpoints, the epoch-0 rule, the best-model re-evaluation, and a run
preempted mid-epoch (and one on an epoch boundary) that resumes to the
bit-identical end state of an uninterrupted run."""

import json
import os

import numpy as np
import pytest
import torch

from change3d_tpu_torch import cli
from change3d_tpu_torch.data.png import write_png
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import X3DConfig
from change3d_tpu_torch.train import loop

from tests.test_torch_model import TINY

HW = 16


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """16 train pairs (2 batches of 8 per epoch) and 5 test pairs."""
    root = str(tmp_path_factory.mktemp("levir"))
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
    return root


@pytest.fixture
def tiny_model(monkeypatch):
    def build(cfg):
        return Change3D(Task.BCD, in_height=cfg.in_height, in_width=cfg.in_width,
                        backbone_cfg=X3DConfig(**TINY), device=cfg.device,
                        generator=torch.Generator().manual_seed(cfg.seed))

    monkeypatch.setattr(loop, "build_model", build)
    monkeypatch.delenv("CHANGE3D_PREEMPT_AFTER_STEP", raising=False)


def _argv(root, save_dir, epochs, *extra):
    return ["bcd", "--file_root", root, "--save_dir", save_dir, "--device", "cpu",
            "--in_height", str(HW), "--in_width", str(HW), "--batch_size", "8",
            "--num_workers", "2", "--max_epochs", str(epochs), "--compute_dtype", "float32",
            "--lr", "1e-3", *extra]


def _run_dir(save_dir):
    return os.path.join(save_dir, "LEVIR-CD_iter_80000_lr_0.001")


def _final_state(save_dir):
    ckpt = os.path.join(_run_dir(save_dir), "ckpt")
    step = max(int(d) for d in os.listdir(ckpt) if d.isdigit())
    return step, torch.load(os.path.join(ckpt, str(step), "state.pt"))


def _assert_bit_identical(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_bit_identical(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_bit_identical(x, y)
    else:
        assert a == b


def _logged(save_dir, split="val"):
    with open(os.path.join(_run_dir(save_dir), "train_val_log.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [r for r in rows if r.get("event") == "epoch" and r["split"] == split]


def test_cli_trains_validates_and_checkpoints(data_root, tmp_path, tiny_model):
    save = str(tmp_path / "run")
    res = cli.main(_argv(data_root, save, 3))
    run_dir = _run_dir(save)
    for name in ("train_val_log.txt", "train_val_log.jsonl", "best/model.pt",
                 "ckpt/train_meta.json"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    # Epoch 0 is never validated; epochs 1 and 2 are, then the best model.
    assert [r["epoch"] for r in _logged(save)] == [1, 2]
    assert 0.0 <= _logged(save)[0]["F1"] <= 1.0
    assert len(_logged(save, "test_best")) == 1
    assert res["steps"] == 6 and set(res["test_best"]) >= {"F1", "IoU", "OA", "loss"}
    with open(os.path.join(run_dir, "ckpt", "train_meta.json")) as f:
        meta = json.load(f)
    assert meta["best_val"] == max(r["F1"] for r in _logged(save))
    # Checkpoints after epochs 1 and 2 (max_to_keep 2); epoch 0 saves none.
    assert sorted(d for d in os.listdir(os.path.join(run_dir, "ckpt")) if d.isdigit()) == ["4", "6"]
    step, state = _final_state(save)
    assert step == 6 and state["step"] == 6
    # --resume restores the last step; with every epoch done it only re-evaluates.
    res2 = cli.main(_argv(data_root, save, 3, "--resume"))
    assert res2["resumed_from_step"] == 6 and res2["steps"] == 6


@pytest.mark.parametrize("preempt_at, epochs", [(3, 2), (4, 3)], ids=["mid_epoch", "boundary"])
def test_preempted_run_resumes_bit_identically(data_root, tmp_path, tiny_model, monkeypatch,
                                               preempt_at, epochs):
    straight, killed = str(tmp_path / "straight"), str(tmp_path / "killed")
    res_a = cli.main(_argv(data_root, straight, epochs))
    assert "preempted_at_step" not in res_a

    monkeypatch.setenv("CHANGE3D_PREEMPT_AFTER_STEP", str(preempt_at))
    res_b = cli.main(_argv(data_root, killed, epochs))
    assert res_b["preempted_at_step"] == preempt_at
    assert _final_state(killed)[0] == preempt_at

    monkeypatch.delenv("CHANGE3D_PREEMPT_AFTER_STEP")
    res_c = cli.main(_argv(data_root, killed, epochs, "--resume"))
    assert res_c["resumed_from_step"] == preempt_at and "preempted_at_step" not in res_c

    step_a, state_a = _final_state(straight)
    step_c, state_c = _final_state(killed)
    assert step_a == step_c == 2 * epochs
    _assert_bit_identical(state_a, state_c)  # parameters, BN stats, optimizer, step
    assert [r["epoch"] for r in _logged(killed)] == [r["epoch"] for r in _logged(straight)]
    assert res_a["last"] == res_c["last"]
    assert res_a["test_best"] == res_c["test_best"]


def test_cli_defaults_to_the_card_and_refuses_unported_flags(data_root, tmp_path, tiny_model,
                                                             capsys):
    argv = [a for a in _argv(data_root, str(tmp_path / "x"), 1) if a not in ("--device", "cpu")]
    args = cli.build_parser().parse_args(argv)
    assert args.device == "cuda" and cli.build_parser().parse_args(
        ["bcd", "--file_root", "r"]).compute_dtype == "bfloat16"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
    for flag in ("--packed", "--no-packed"):
        with pytest.raises(SystemExit):
            cli.main(_argv(data_root, str(tmp_path / "y"), 1, flag, "X3D_L.pyth"))
        assert f"{flag} is not ported yet" in capsys.readouterr().err
    # --loader is ported: grain (the worker-process loader) parses, and an
    # unknown kind is refused.
    assert cli.build_parser().parse_args(argv + ["--loader", "grain"]).loader == "grain"
    assert args.loader == "threaded"
    with pytest.raises(SystemExit):
        cli.main(_argv(data_root, str(tmp_path / "y"), 1, "--loader", "bogus"))
    assert "invalid choice: 'bogus'" in capsys.readouterr().err
    # --remat is ported (off by default; tests/test_torch_remat.py).
    assert cli.build_parser().parse_args(argv + ["--remat"]).remat
    assert not args.remat
