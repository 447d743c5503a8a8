"""The detection half of the port's deploy CLI on the CPU: ``cli eval`` of a
trained TINY BCD run equals the run's final report and, on bridged weights,
JAX ``run_detection_eval`` within 1e-6; ``cli convert-reference`` then ``cli
predict`` writes the masks of a ``Predictor`` built from the same state_dict
(byte-equal PNGs), tiled too; SCD / BDA mask names; ``--pretrained`` starts
training from the Kinetics backbone; refused flags name their slice; every
subcommand defaults to the card."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.checkpoint.orbax_io import CheckpointManager as JaxCheckpointManager
from change3d_tpu.models.trainer import Change3D as JaxChange3D, Task as JaxTask
from change3d_tpu.models.x3d import x3d_l_config as jax_x3d_l_config
from change3d_tpu.train import loop as jax_loop
from change3d_tpu_torch import cli
from change3d_tpu_torch.checkpoint.convert import (
    from_jax_variables,
    load_trainer_pretrained,
    load_x3d_pretrained,
)
from change3d_tpu_torch.checkpoint.io import CheckpointManager
from change3d_tpu_torch.data.datasets import DATASETS
from change3d_tpu_torch.data.pipeline import DataLoader, pair_collate
from change3d_tpu_torch.data.png import encode_png_bytes, write_png
from change3d_tpu_torch.data.transforms import eval_normalize, make_transform_pipelines
from change3d_tpu_torch.inference import Predictor, TiledPredictor
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import X3DConfig
from change3d_tpu_torch.serving import masks_to_arrays

from tests.test_convert_reference import make_trainer_sd
from tests.test_torch_model import TINY, _cfgs, _random_vars
from tests.test_torch_train_loop import HW, _argv, _run_dir, data_root, tiny_model  # noqa: F401
from tests.torch_oracle import make_random_x3d_state_dict


def _eval_argv(run_dir, root, *extra):
    return ["eval", "--model_task", "bcd", "--checkpoint", run_dir, "--file_root", root,
            "--device", "cpu", "--in_height", str(HW), "--in_width", str(HW), "--batch_size",
            "8", "--num_workers", "2", "--json", *extra]


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_eval_equals_the_training_report(data_root, tmp_path, tiny_model, capsys):
    save = str(tmp_path / "run")
    res = cli.main(_argv(data_root, save, 3))
    capsys.readouterr()
    assert cli.main(_eval_argv(_run_dir(save), data_root, "--compute_dtype", "float32")) == 0
    assert _json_line(capsys) == res["test_best"]
    # --which latest scores the newest checkpoint: the weights of the last epoch.
    assert cli.main(_eval_argv(_run_dir(save), data_root, "--which", "latest")) == 0
    assert _json_line(capsys) == res["last"]


def test_eval_matches_jax_run_detection_eval(data_root, tmp_path, tiny_model, monkeypatch,
                                             capsys):
    jcfg, cfg = _cfgs(False)
    jmodel = JaxChange3D(task=JaxTask.BCD, in_height=HW, in_width=HW, backbone_cfg=jcfg)
    z = jnp.zeros((1, HW, HW, 3), jnp.float32)
    variables = _random_vars(jmodel, z, z, seed=21)
    JaxCheckpointManager(str(tmp_path / "jax")).save_best(variables)
    monkeypatch.setattr(jax_loop, "build_model", lambda c: jmodel)
    want = jax_loop.run_detection_eval(
        jax_loop.RunConfig(task="bcd", file_root=data_root, in_height=HW, in_width=HW,
                           batch_size=8, num_workers=2, compute_dtype="float32"),
        run_dir=str(tmp_path / "jax"))

    model = Change3D(Task.BCD, in_height=HW, in_width=HW, backbone_cfg=X3DConfig(**TINY),
                     device="cpu")
    model.load_state_dict(from_jax_variables(variables, X3DConfig(**TINY)))
    CheckpointManager(str(tmp_path / "port")).save_best(model)
    assert cli.main(_eval_argv(str(tmp_path / "port"), data_root)) == 0
    got = _json_line(capsys)
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - float(v)) <= 1e-6, (k, got[k], v)


@pytest.fixture(scope="module")
def reference_bcd(tmp_path_factory):
    """A reference-trained BCD checkpoint.pth.tar for the full X3D-L at 32²,
    converted by ``cli convert-reference``, and a LEVIR layout at 32²."""
    root = tmp_path_factory.mktemp("ref")
    sd = make_trainer_sd("bcd", 1, cfg=jax_x3d_l_config(), hw=(32, 32))
    torch.save({"state_dict": sd, "epoch": 3}, str(root / "checkpoint.pth.tar"))
    rs = np.random.RandomState(0)
    for split, n, hw in (("test", 5, 32), ("scenes", 2, 40)):
        for d in ("t1", "t2", "label"):
            os.makedirs(root / "data" / split / d)
        for i in range(n):
            for d in ("t1", "t2"):
                write_png(str(root / "data" / split / d / f"{i:02d}.png"),
                          rs.randint(0, 256, (hw, hw + 8 * i, 3)).astype(np.uint8))
            write_png(str(root / "data" / split / "label" / f"{i:02d}.png"),
                      np.zeros((hw, hw + 8 * i), np.uint8))
    assert cli.main(["convert-reference", "--model_task", "bcd", "--torch_checkpoint",
                     str(root / "checkpoint.pth.tar"), "--out", str(root / "run"),
                     "--in_height", "32", "--in_width", "32", "--device", "cpu"]) == 0
    return root


def _direct_predictor(root):
    model = Change3D(Task.BCD, in_height=32, in_width=32, device="cpu")
    model.load_state_dict(load_trainer_pretrained(str(root / "checkpoint.pth.tar"),
                                                  model.state_dict()))
    return Predictor(model, compute_dtype=torch.float32, device="cpu")


def test_converted_run_predicts_what_a_direct_predictor_does(reference_bcd):
    root = reference_bcd
    out = root / "masks"
    assert cli.main(["predict", "--model_task", "bcd", "--checkpoint", str(root / "run"),
                     "--file_root", str(root / "data"), "--out", str(out), "--in_height", "32",
                     "--in_width", "32", "--batch_size", "2", "--compute_dtype", "float32",
                     "--device", "cpu"]) == 0
    pred = _direct_predictor(root)
    _, eval_tf = make_transform_pipelines("bcd", 32, 32)
    ds = DATASETS["bcd"](str(root / "data"), "test", eval_tf)
    names = sorted(os.listdir(out))
    assert names == [f"{i:02d}.png" for i in range(5)]
    i = 0
    for batch in DataLoader(ds, 2, num_workers=1, pad_final=True, collate=pair_collate):
        valid = batch.pop("valid")
        maps = pred.predict(batch["pre"], batch["post"])
        for j in np.flatnonzero(valid):
            want = encode_png_bytes(masks_to_arrays("bcd", {"change": maps["change"][j]})["change"])
            assert (out / names[i]).read_bytes() == want
            i += 1
    assert i == 5


def test_tiled_predict_writes_native_size_scenes(reference_bcd):
    root = reference_bcd
    out = root / "tiled"
    assert cli.main(["predict", "--model_task", "bcd", "--checkpoint", str(root / "run"),
                     "--file_root", str(root / "data"), "--split", "scenes", "--out", str(out),
                     "--in_height", "32", "--in_width", "32", "--batch_size", "3", "--tiled",
                     "--tile_overlap", "8", "--compute_dtype", "float32", "--device", "cpu"]) == 0
    tiled = TiledPredictor(_direct_predictor(root), overlap=8, batch_size=3)
    ds = DATASETS["bcd"](str(root / "data"), "scenes", None)
    for idx in range(2):
        img, _ = ds[idx]
        img = eval_normalize(img)
        want = tiled.predict_scene(img[..., :3], img[..., 3:])["change"]
        assert want.shape == (40, 40 + 8 * idx)
        assert (out / f"{idx:02d}.png").read_bytes() == encode_png_bytes(
            want.astype(np.uint8) * 255)


@pytest.mark.parametrize("task", ["scd", "bda"])
def test_predict_names_the_masks_of_scd_and_bda(task, tmp_path, monkeypatch):
    from change3d_tpu_torch.train import loop

    classes = {"scd": 6, "bda": 5}[task]
    monkeypatch.setattr(loop, "build_model", lambda c: Change3D(
        Task(task), num_classes=c.num_classes, in_height=c.in_height, in_width=c.in_width,
        backbone_cfg=X3DConfig(**TINY), device=c.device))
    run = str(tmp_path / "run")
    model = loop.build_model(loop.RunConfig(task=task, num_classes=classes, in_height=16,
                                            in_width=16, device="cpu"))
    CheckpointManager(run).save_best(model)
    data = tmp_path / "data" / "test"
    labels = {"scd": ("label1", "label2", "change"), "bda": ("label1", "label2")}[task]
    name = "a-flood_00000001_post_disaster.png"
    rs = np.random.RandomState(1)
    for d in ("t1", "t2") + labels:
        os.makedirs(data / d)
        img = (rs.randint(0, 256, (16, 16, 3)) if d in ("t1", "t2")
               else np.zeros((16, 16))).astype(np.uint8)
        write_png(str(data / d / (name if d in ("t1", "t2") or task == "scd"
                                  else name.replace("disaster", "disaster_target"))), img)
    out = tmp_path / "out"
    assert cli.main(["predict", "--model_task", task, "--checkpoint", run, "--file_root",
                     str(tmp_path / "data"), "--out", str(out), "--in_height", "16",
                     "--in_width", "16", "--device", "cpu"]) == 0
    stem = name[:-4]
    want = {"scd": ["_change", "_post", "_pre"], "bda": ["_cls", "_loc"]}[task]
    assert sorted(os.listdir(out)) == [f"{stem}{s}.png" for s in want]


def test_pretrained_starts_training_from_the_kinetics_backbone(data_root, tmp_path, tiny_model):
    path = str(tmp_path / "X3D_L.pyth")
    torch.save({"model_state": make_random_x3d_state_dict(_cfgs(False)[0], seed=4)}, path)
    # lr 0: Adam moves nothing, so the checkpoint holds the loaded weights
    # (BN running statistics still move in train mode).
    save = str(tmp_path / "run")
    cli.main(_argv(data_root, save, 2, "--pretrained", path, "--lr", "0"))
    state = torch.load(os.path.join(save, "LEVIR-CD_iter_80000_lr_0.0", "ckpt", "4", "state.pt"))
    backbone = load_x3d_pretrained(path, X3DConfig(**TINY))
    for key in ("stem.conv_s", "stage1.block0.bottleneck.conv_a", "stage2.block0.proj",
                "stage3.block2.bottleneck.se.w_reduce"):
        assert torch.equal(state["model"][f"encoder.x3d.{key}"], backbone[key]), key


def test_refused_flags_name_their_slice(capsys):
    cases = [
        (["eval", "--model_task", "bcd", "--checkpoint", "c", "--file_root", "f",
          "--packed"], "never ported"),
        (["predict", "--model_task", "bcd", "--checkpoint", "c", "--file_root", "f",
          "--out", "o", "--platform", "cpu"], "--device"),
        (["serve", "--model_task", "bcd", "--checkpoint", "c", "--packed"], "never ported"),
        (["export", "--model_task", "bcd", "--checkpoint", "c", "--out", "x", "--platform",
          "cpu"], "--device"),
        (["export", "--model_task", "bcd", "--checkpoint", "c", "--out", "x", "--platforms",
          "cpu,tpu"], "--device"),
        (["bcd", "--file_root", "r", "--packed"], "never ported"),
        (["info", "--model_task", "bcd", "--platform", "cpu"], "--device"),
    ]
    for argv, reason in cases:
        with pytest.raises(SystemExit):
            cli.main(argv)
        err = capsys.readouterr().err
        assert "is not ported yet" in err and reason in err, (argv, err)
    # --loader is ported: grain (the worker-process loader) parses for bcd
    # and cc, and an unknown kind is refused.
    for task in ("bcd", "cc"):
        assert cli.build_parser().parse_args([task, "--file_root", "r", "--loader", "grain"]
                                             ).loader == "grain"
        with pytest.raises(SystemExit):
            cli.main([task, "--file_root", "r", "--loader", "bogus"])
        assert "invalid choice: 'bogus'" in capsys.readouterr().err
    # The multi-GPU, int8 and remat flags are ported: they parse (--shard is
    # refused only beside --artifact, tests/test_torch_parallel_predict.py).
    parser = cli.build_parser()
    args = parser.parse_args(["eval", "--model_task", "bcd", "--checkpoint", "c", "--file_root",
                              "f", "--quantized", "--quant_mode", "static", "--calib_batches",
                              "4"])
    assert (args.quantized, args.quant_mode, args.calib_batches) == (True, "static", 4)
    args = parser.parse_args(["export", "--model_task", "bcd", "--checkpoint", "c", "--out",
                              "x", "--quantized", "--calib_batch_size", "2"])
    assert (args.quantized, args.quant_mode, args.calib_batches, args.calib_batch_size) == (
        True, "dynamic", 8, 2)
    assert parser.parse_args(["serve", "--model_task", "bcd", "--checkpoint", "c",
                              "--quantized"]).quantized
    assert parser.parse_args(["bcd", "--file_root", "r", "--remat"]).remat
    assert not parser.parse_args(["bcd", "--file_root", "r"]).remat
    assert parser.parse_args(["predict", "--model_task", "bcd", "--checkpoint", "c",
                              "--file_root", "f", "--out", "o", "--shard"]).shard
    assert parser.parse_args(["serve", "--model_task", "bcd", "--checkpoint", "c",
                              "--shard"]).shard
    assert parser.parse_args(["bcd", "--file_root", "r", "--num_processes", "2"]
                             ).num_processes == 2
    # --fused is accepted and changes nothing: evaluation always runs fused.
    args = cli.build_parser().parse_args(["eval", "--model_task", "bcd", "--checkpoint", "c",
                                          "--file_root", "f", "--fused"])
    assert args.fused and args.device == "cuda" and args.compute_dtype == "float32"


def test_every_subcommand_defaults_to_the_card(reference_bcd, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    root = reference_bcd
    for argv in (
        ["predict", "--model_task", "bcd", "--checkpoint", str(root / "run"), "--file_root",
         str(root / "data"), "--out", str(tmp_path / "o")],
        ["eval", "--model_task", "bcd", "--checkpoint", str(root / "run"), "--file_root",
         str(root / "data")],
        ["serve", "--model_task", "bcd", "--checkpoint", str(root / "run"), "--port", "0"],
        ["info", "--model_task", "bcd"],
        ["convert-reference", "--model_task", "bcd", "--torch_checkpoint",
         str(root / "checkpoint.pth.tar"), "--out", str(tmp_path / "r")],
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)


def test_serve_builds_a_warmed_service_from_a_run(reference_bcd):
    """What ``cli serve`` serves: the run's weights behind a PredictService
    with the ladder of buckets, warmed up (statistics zeroed)."""
    root = reference_bcd
    args = cli.build_parser().parse_args(
        ["serve", "--model_task", "bcd", "--checkpoint", str(root / "run"), "--in_height", "32",
         "--in_width", "32", "--batch_size", "4", "--compute_dtype", "float32", "--device",
         "cpu"])
    service = cli.build_service(args)
    try:
        assert service.buckets == (1, 2, 4) and service.health()["input_hw"] == [32, 32]
        assert service.stats.snapshot()["requests_total"] == 0
        pre, post = (np.random.RandomState(i).randint(0, 256, (32, 32, 3)).astype(np.uint8)
                     for i in range(2))
        want = _direct_predictor(root).predict_u8(pre[None], post[None])["change"][0]
        np.testing.assert_array_equal(service._batcher.submit(pre, post)["change"], want)
    finally:
        service.close()
