"""The int8 CLI of the port on the CPU, with the TINY backbone on a 16²
LEVIR layout (depths cut to 1, 1, 1): ``cli predict`` / ``eval`` / ``export --quantized`` in the
dynamic and static regimes give what a directly built int8 model gives
(static: calibrated on the same first train batches), the artifact keeps
its int8 products (``aten._int_mm`` nodes, padding static under the
symbolic batch), and ``serve --quantized`` serves the int8 model (CC:
``tests/test_torch_quant_cc.py``)."""

import json
import os

import numpy as np
import pytest
import torch

from change3d_tpu_torch import cli
from change3d_tpu_torch.checkpoint.io import CheckpointManager
from change3d_tpu_torch.data.datasets import DATASETS
from change3d_tpu_torch.data.pipeline import DataLoader, pair_collate
from change3d_tpu_torch.data.png import encode_png_bytes
from change3d_tpu_torch.data.transforms import make_transform_pipelines
from change3d_tpu_torch.export import load_exported
from change3d_tpu_torch.inference import Predictor
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import X3DConfig
from change3d_tpu_torch.ops import quant
from change3d_tpu_torch.serving import masks_to_arrays
from change3d_tpu_torch.train import loop

from tests._torch_parallel import few_threads  # noqa: F401 (autouse)
from tests.test_torch_model import TINY
from tests.test_torch_train_loop import HW, data_root  # noqa: F401

MODES = ["dynamic", "static"]
# TINY's widths at depths (1, 1, 1): 3 blocks, 6 int8 products per forward
# (a short graph keeps torch.export quick).
SHORT = dict(TINY, stage_depths=(1, 1, 1, 1))


def _build(cfg):
    return Change3D(Task.BCD, in_height=cfg.in_height, in_width=cfg.in_width,
                    backbone_cfg=loop.backbone_config(cfg, X3DConfig(**SHORT)),
                    device=cfg.device, generator=torch.Generator().manual_seed(cfg.seed))


@pytest.fixture
def run(tmp_path, monkeypatch):
    """A saved TINY BCD run (seeded weights), ``build_model`` at TINY width."""
    monkeypatch.setattr(loop, "build_model", _build)
    run_dir = str(tmp_path / "run")
    CheckpointManager(run_dir).save_best(_build(loop.RunConfig(in_height=HW, in_width=HW,
                                                               device="cpu")))
    return run_dir


def _direct(run_dir, root, mode, batch_size):
    """The int8 model of the run, built and calibrated outside the CLI."""
    cfg = loop.RunConfig(file_root=root, in_height=HW, in_width=HW, device="cpu",
                         batch_size=batch_size, quantized=True, quant_mode=mode,
                         calib_batches=2)
    model = _build(cfg)
    model.load_state_dict(torch.load(os.path.join(run_dir, "best", "model.pt")))
    if mode == "static":
        loop.calibrate_from_train_split(cfg, model)
    return model


def _flags(mode):
    return ["--in_height", str(HW), "--in_width", str(HW), "--device", "cpu", "--quantized",
            "--quant_mode", mode, "--calib_batches", "2"]


@pytest.mark.parametrize("mode", MODES)
def test_predict_and_eval_quantized_equal_a_direct_int8_model(run, data_root, tmp_path, mode,
                                                              capsys):
    out = tmp_path / "masks"
    before = quant.int8_matmul.launches
    assert cli.main(["predict", "--model_task", "bcd", "--checkpoint", run, "--file_root",
                     data_root, "--out", str(out), "--batch_size", "4", "--compute_dtype",
                     "float32", *_flags(mode)]) == 0
    # Two 4-pair batches of 5 test pairs (the calibration runs fp32 convs).
    assert quant.int8_matmul.launches - before == 2 * 6
    model = _direct(run, data_root, mode, 4)
    pred = Predictor(model, compute_dtype=torch.float32, device="cpu")
    _, eval_tf = make_transform_pipelines("bcd", HW, HW)
    ds = DATASETS["bcd"](data_root, "test", eval_tf)
    names, i = sorted(os.listdir(out)), 0
    for batch in DataLoader(ds, 4, pad_final=True, collate=pair_collate):
        valid = batch.pop("valid")
        maps = pred.predict(batch["pre"], batch["post"])
        for j in np.flatnonzero(valid):
            want = encode_png_bytes(masks_to_arrays("bcd", {"change": maps["change"][j]})["change"])
            assert (out / names[i]).read_bytes() == want
            i += 1
    assert i == len(names) == 5
    capsys.readouterr()
    assert cli.main(["eval", "--model_task", "bcd", "--checkpoint", run, "--file_root",
                     data_root, "--batch_size", "4", "--num_workers", "1", "--json",
                     *_flags(mode)]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    loader = DataLoader(ds, 4, pad_final=True, collate=pair_collate)
    want = loop._evaluate_split(loop.RunConfig(), model, loader, torch.device("cpu"), None)
    assert got == json.dumps(want)


@pytest.mark.parametrize("mode", MODES)
def test_export_quantized_keeps_the_int8_products(run, data_root, tmp_path, mode):
    """Dynamic with a symbolic batch (the padding stays static under it),
    static pinned to batch 3 (a shorter export)."""
    path = str(tmp_path / "bcd.pt2")
    argv = ["export", "--model_task", "bcd", "--checkpoint", run, "--out", path,
            "--calib_batch_size", "4", *_flags(mode)]
    batches = (2, 3)
    if mode == "static":
        with pytest.raises(SystemExit, match="needs --file_root"):
            cli.main(argv)
        argv += ["--file_root", data_root, "--batch", "3"]
        batches = (3,)
    assert cli.main(argv) == 0
    fn = load_exported(path, "cpu")
    nodes = [n for n in fn.program.graph.nodes if n.target == torch.ops.aten._int_mm.default]
    assert len(nodes) == 6
    assert fn.input_shape[0] == 3 if mode == "static" else isinstance(fn.input_shape[0], str)
    model = _direct(run, data_root, mode, 4)
    pred = Predictor(model, device="cpu")  # bf16, as exported
    rs = np.random.RandomState(3)
    for b in batches:
        pre, post = (rs.randn(b, HW, HW, 3).astype(np.float32) for _ in range(2))
        got = fn(pre, post)["change"].numpy()
        want = pred.predict_probs(pre, post)["change"]
        np.testing.assert_array_equal(got > 0.5, want > 0.5)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_serve_quantized_serves_the_int8_model(run, monkeypatch):
    from change3d_tpu_torch import serving

    served = []
    monkeypatch.setattr(serving, "PredictService", lambda task, pred, **kw: served.append(pred))
    args = cli.build_parser().parse_args(
        ["serve", "--model_task", "bcd", "--checkpoint", run, "--in_height", str(HW),
         "--in_width", str(HW), "--device", "cpu", "--quantized"])
    cli.build_service(args)
    cfg = served[0].model.backbone_cfg
    assert cfg.quantized_eval and cfg.quant_mode == "dynamic"
    with pytest.raises(SystemExit, match="--quantized applies to checkpoint-backed"):
        cli.main(["serve", "--model_task", "bcd", "--artifact", "a.pt2", "--quantized",
                  "--device", "cpu"])
