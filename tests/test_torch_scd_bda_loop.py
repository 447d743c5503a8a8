"""``python -m change3d_tpu_torch.cli scd`` and ``cli bda --device cpu`` end
to end on tiny synthetic SECOND and xBD layouts written with data/png.py,
with the TINY backbone: the task's metrics logged and its best metric
gating best/, and a run preempted mid-epoch that resumes to the
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
from tests.test_torch_train_loop import _assert_bit_identical

HW = 16
DATASET = {"scd": "SECOND", "bda": "xBD"}
BEST = {"scd": "IoU_mean", "bda": "overall_f1"}


def write_layout(root, task, rs, n_train=8, n_test=3):
    """SECOND: {t1,t2,label1,label2,change}; xBD: {t1,t2,label1,label2}
    with the label files named '..._disaster_target...'. A repainted
    rectangle is the change: its classes in SCD, damage in BDA."""
    dirs = {"scd": ("label1", "label2", "change"), "bda": ("label1", "label2")}[task]
    for split, n in (("train", n_train), ("test", n_test)):
        for d in ("t1", "t2") + dirs:
            os.makedirs(os.path.join(root, split, d))
        for i in range(n):
            pre = rs.randint(0, 256, (HW, HW, 3)).astype(np.uint8)
            post = pre.copy()
            post[4:10, 3:12] = rs.randint(0, 256, (6, 9, 3))
            box = np.zeros((HW, HW), np.uint8)
            box[4:10, 3:12] = 1
            if task == "scd":
                labels = (box * rs.randint(1, 6), box * rs.randint(1, 6), box)
                name = f"{i:03d}.png"
            else:
                labels = (box, box * rs.randint(1, 5))
                name = f"palu-tsunami_{i:03d}_post_disaster.png"
            write_png(os.path.join(root, split, "t1", name), pre)
            write_png(os.path.join(root, split, "t2", name), post)
            for d, lab in zip(dirs, labels):
                write_png(os.path.join(root, split, d,
                                       name.replace("disaster", "disaster_target")), lab)


@pytest.fixture(scope="module", params=["scd", "bda"])
def layout(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(request.param))
    write_layout(root, request.param, np.random.RandomState(0))
    return request.param, root


@pytest.fixture
def tiny_model(monkeypatch):
    def build(cfg):
        return Change3D(Task(cfg.task), num_classes=cfg.num_classes, in_height=cfg.in_height,
                        in_width=cfg.in_width, backbone_cfg=X3DConfig(**TINY), device=cfg.device,
                        generator=torch.Generator().manual_seed(cfg.seed))

    monkeypatch.setattr(loop, "build_model", build)
    monkeypatch.delenv("CHANGE3D_PREEMPT_AFTER_STEP", raising=False)


def _argv(task, root, save_dir, epochs, *extra):
    return [task, "--file_root", root, "--save_dir", save_dir, "--device", "cpu",
            "--in_height", str(HW), "--in_width", str(HW), "--batch_size", "4",
            "--num_workers", "2", "--max_epochs", str(epochs), "--compute_dtype", "float32",
            "--lr", "1e-3", *extra]


def _run_dir(task, save_dir):
    steps = {"scd": 80000, "bda": 200000}[task]
    return os.path.join(save_dir, f"{DATASET[task]}_iter_{steps}_lr_0.001")


def _final_state(task, save_dir):
    ckpt = os.path.join(_run_dir(task, save_dir), "ckpt")
    step = max(int(d) for d in os.listdir(ckpt) if d.isdigit())
    return step, torch.load(os.path.join(ckpt, str(step), "state.pt"))


def _logged(task, save_dir, split="val"):
    with open(os.path.join(_run_dir(task, save_dir), "train_val_log.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [r for r in rows if r.get("event") == "epoch" and r["split"] == split]


def test_cli_trains_validates_and_resumes(layout, tmp_path, tiny_model):
    task, root = layout
    save = str(tmp_path / "run")
    res = cli.main(_argv(task, root, save, 2))
    run_dir = _run_dir(task, save)
    for name in ("train_val_log.jsonl", "best/model.pt", "ckpt/train_meta.json"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    val = _logged(task, save)
    assert [r["epoch"] for r in val] == [1]  # epoch 0 is never validated
    want = {"scd": {"Fscd", "IoU_mean", "Sek", "acc", "loss"},
            "bda": {"loc_f1", "harmonic_mean_f1", "overall_f1", "damage_f1_class1",
                    "damage_f1_class4", "loss"}}[task]
    assert set(res["test_best"]) >= want and set(val[0]) >= want
    assert all(np.isfinite(v) for k, v in res["test_best"].items())
    with open(os.path.join(run_dir, "ckpt", "train_meta.json")) as f:
        assert json.load(f)["best_val"] == val[0][BEST[task]]
    heads = {k.split(".")[0] for k in torch.load(os.path.join(run_dir, "best", "model.pt"))
             if k.startswith("decoder")}
    assert heads == ({"decoder_pre", "decoder_post", "decoder_change"} if task == "scd"
                     else {"decoder_cls", "decoder_loc"})
    assert res["steps"] == 4 and _final_state(task, save)[0] == 4
    res2 = cli.main(_argv(task, root, save, 2, "--resume"))
    assert res2["resumed_from_step"] == 4 and res2["steps"] == 4


def test_preempted_run_resumes_bit_identically(layout, tmp_path, tiny_model, monkeypatch):
    task, root = layout
    straight, killed = str(tmp_path / "straight"), str(tmp_path / "killed")
    res_a = cli.main(_argv(task, root, straight, 2))
    monkeypatch.setenv("CHANGE3D_PREEMPT_AFTER_STEP", "3")
    res_b = cli.main(_argv(task, root, killed, 2))
    assert res_b["preempted_at_step"] == 3
    monkeypatch.delenv("CHANGE3D_PREEMPT_AFTER_STEP")
    res_c = cli.main(_argv(task, root, killed, 2, "--resume"))
    assert res_c["resumed_from_step"] == 3 and "preempted_at_step" not in res_c
    (step_a, state_a), (step_c, state_c) = _final_state(task, straight), _final_state(task, killed)
    assert step_a == step_c == 4
    _assert_bit_identical(state_a, state_c)  # parameters, BN stats, optimizer, step
    assert res_a["last"] == res_c["last"] and res_a["test_best"] == res_c["test_best"]


@pytest.mark.parametrize("task", ["scd", "bda"])
def test_cli_defaults_follow_the_jax_cli(task, tmp_path, capsys):
    args = cli.build_parser().parse_args([task, "--file_root", "r"])
    want = {"scd": ("SECOND", 6, 8, 80_000), "bda": ("xBD", 5, 12, 200_000)}[task]
    assert (args.dataset, args.num_classes, args.batch_size, args.max_steps) == want
    assert args.device == "cuda" and args.compute_dtype == "bfloat16"
    assert cli.build_parser().parse_args([task, "--file_root", "r", "--num_class", "7"]
                                         ).num_classes == 7
    for flag in ("--packed", "--no-packed"):
        with pytest.raises(SystemExit):
            cli.main([task, "--file_root", "r", flag, "x"])
        assert f"{flag} is not ported yet" in capsys.readouterr().err
    # --loader is ported: grain (the worker-process loader) parses, and an
    # unknown kind is refused.
    assert cli.build_parser().parse_args([task, "--file_root", "r", "--loader", "grain"]
                                         ).loader == "grain"
    with pytest.raises(SystemExit):
        cli.main([task, "--file_root", "r", "--loader", "bogus"])
    assert "invalid choice: 'bogus'" in capsys.readouterr().err
    assert cli.build_parser().parse_args([task, "--file_root", "r", "--remat"]).remat
    # The multi-process flags are ported: they parse.
    args = cli.build_parser().parse_args([task, "--file_root", "r", "--coordinator_address",
                                          "127.0.0.1:1", "--num_processes", "2",
                                          "--process_id", "1"])
    assert (args.coordinator_address, args.num_processes, args.process_id) == (
        "127.0.0.1:1", 2, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main([task, "--file_root", str(tmp_path), "--save_dir", str(tmp_path / "x")])


def test_run_config_refuses_an_unknown_task(tmp_path):
    with pytest.raises(ValueError, match="task 'cc'"):
        loop.run_detection_training(loop.RunConfig(task="cc", save_dir=str(tmp_path)))
