"""``cli export`` and ``serve --artifact`` of the port on the CPU: a TINY
BCD run (``train.loop.build_model`` monkeypatched, as the deploy tests do)
exported with ``--device cpu`` gives the masks and probabilities of the live
``Predictor`` on its weights (bf16, the CLI's dtype: the same ops run);
``--batch 4`` pins the batch; the artifact served through ``make_server``
on 127.0.0.1 answers the masks of ``ArtifactPredictor.predict`` on the same
batch; a pinned artifact refuses another ``--batch_size`` with JAX's
message and serves one bucket; the float path normalises on the host
(``eval_normalize``; ImageNet's mean and std for CC) and never uses the
pipelined launch; ``--checkpoint`` and ``--artifact`` exclude each other;
``--platforms`` / ``--platform`` and the int8 flags are refused."""

import os

import numpy as np
import pytest
import torch

from change3d_tpu_torch import cli
from change3d_tpu_torch.checkpoint.io import CheckpointManager
from change3d_tpu_torch.client import PredictClient
from change3d_tpu_torch.data.datasets import CaptionDataset
from change3d_tpu_torch.data.transforms import eval_normalize
from change3d_tpu_torch.inference import ArtifactPredictor, Predictor
from change3d_tpu_torch.serving import PredictService

from tests.test_torch_deploy_serving import Served, serve  # noqa: F401
from tests.test_torch_train_loop import HW, tiny_model  # noqa: F401
from change3d_tpu_torch.train import loop


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run dir whose best/model.pt holds a seeded TINY BCD model."""
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3DConfig

    from tests.test_torch_model import TINY

    root = str(tmp_path_factory.mktemp("run"))
    model = Change3D(Task.BCD, in_height=HW, in_width=HW, backbone_cfg=X3DConfig(**TINY),
                     device="cpu", seed=7)
    CheckpointManager(root).save_best(model)
    return root


def _export(run_dir, out, *extra):
    return cli.main(["export", "--model_task", "bcd", "--checkpoint", run_dir, "--out", out,
                     "--device", "cpu", "--in_height", str(HW), "--in_width", str(HW), *extra])


def _pairs(seed, n):
    rs = np.random.RandomState(seed)
    return tuple(rs.randint(0, 256, (n, HW, HW, 3)).astype(np.uint8) for _ in range(2))


def test_cli_export_serves_the_live_masks(run_dir, tmp_path, tiny_model, serve, capsys):
    out = str(tmp_path / "bcd.pt2")
    assert _export(run_dir, out) == 0
    assert capsys.readouterr().out.strip() == f"exported {os.path.getsize(out)} bytes to {out}"
    pred = ArtifactPredictor(out, device="cpu")
    assert pred.fixed_batch is None and (pred.model.in_height, pred.model.in_width) == (HW, HW)
    live = Predictor.from_checkpoint(loop.build_model(loop.RunConfig(
        in_height=HW, in_width=HW, device="cpu")), run_dir, device="cpu")
    pre, post = (eval_normalize(a) for a in _pairs(0, 3))
    np.testing.assert_allclose(pred.predict_probs(pre, post)["change"],
                               live.predict_probs(pre, post)["change"], rtol=0, atol=1e-6)
    assert np.array_equal(pred.predict(pre, post)["change"], live.predict(pre, post)["change"])

    args = cli.build_parser().parse_args(["serve", "--model_task", "bcd", "--artifact", out,
                                          "--device", "cpu", "--batch_size", "4",
                                          "--max_delay_ms", "5"])
    served = serve(cli.build_service(args))
    assert served.service.buckets == (1, 2, 4) and not served.service._u8
    client = PredictClient(served.url)
    pres, posts = _pairs(1, 4)
    rgb = lambda a: eval_normalize(a[..., ::-1])  # the client sends RGB for BCD
    got = client.predict_raw_many(pres, posts)["change"]  # one batch of 4
    want = pred.predict(rgb(pres), rgb(posts))["change"]
    np.testing.assert_array_equal(got, want.astype(np.uint8) * 255)
    one = client.predict_raw(pres[0], posts[0])["change"]  # bucket 1
    np.testing.assert_array_equal(one, pred.predict(rgb(pres[:1]), rgb(posts[:1]))["change"][0]
                                  .astype(np.uint8) * 255)
    assert client.metrics()["errors_total"] == 0


def test_pinned_artifact_serves_its_batch_only(run_dir, tmp_path, tiny_model, capsys):
    out = str(tmp_path / "bcd4.pt2")
    assert _export(run_dir, out, "--batch", "4") == 0
    argv = ["serve", "--model_task", "bcd", "--artifact", out, "--device", "cpu",
            "--no_warmup", "--batch_size"]
    with pytest.raises(ValueError, match=r"artifact was exported with a pinned batch of 4; "
                                         r"serve it with --batch_size 4 \(got 8\)"):
        cli.build_service(cli.build_parser().parse_args(argv + ["8"]))
    service = cli.build_service(cli.build_parser().parse_args(argv + ["4"]))
    try:
        assert service.buckets == (4,)
        pre, post = _pairs(2, 1)
        out = service._predict_maps(pre[0], post[0])  # padded to the pinned 4
        assert out["change"].shape == (HW, HW)
    finally:
        service.close()


class _FloatStub:
    """A predictor without the uint8 surface: records what it is given."""

    def __init__(self, cc=False):
        from types import SimpleNamespace

        self.model = SimpleNamespace(in_height=4, in_width=4)
        self.seen = []
        self.cc = cc

    def predict(self, pre, post):
        self.seen.append((pre, post))
        return {"change": pre[..., 0] > 0}

    def caption(self, pre, post):
        self.seen.append((pre, post))
        return [f"{float(p.sum()):.3f}" for p in pre]


@pytest.mark.parametrize("task", ["bcd", "cc"])
def test_float_path_normalises_on_the_host(task):
    stub = _FloatStub()
    service = PredictService(task, stub, batch_size=2, max_delay_ms=1)
    try:
        assert not service._u8 and service._batcher._predict_async is None
        assert service.buckets == ((2,) if task == "cc" else (1, 2))
        rs = np.random.RandomState(3)
        pre, post = (rs.randint(0, 256, (4, 4, 3)).astype(np.uint8) for _ in range(2))
        service._predict_maps(pre, post)
        got = stub.seen[-1][0][0]
        want = (eval_normalize(pre) if task == "bcd" else
                (pre.astype(np.float32) / 255.0 - CaptionDataset.MEAN) / CaptionDataset.STD)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    finally:
        service.close()


def test_serve_source_and_export_refusals(capsys):
    with pytest.raises(SystemExit):
        cli.main(["serve", "--model_task", "bcd", "--checkpoint", "c", "--artifact", "a"])
    assert "not allowed with argument" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["serve", "--model_task", "bcd"])
    assert "one of the arguments --checkpoint --artifact is required" in capsys.readouterr().err
    base = ["export", "--model_task", "bcd", "--checkpoint", "c", "--out", "x"]
    for flag, value, reason in (("--platforms", "cpu,tpu", "use --device"),
                                ("--platform", "cpu", "load_exported(device=...) moves")):
        with pytest.raises(SystemExit):
            cli.main(base + [flag] + ([value] if value else []))
        err = capsys.readouterr().err
        assert f"{flag} is not ported yet" in err and reason in err, err
    args = cli.build_parser().parse_args(base)
    assert (args.device, args.batch, args.beam_size, args.num_class) == ("cuda", None, 1, None)
    # The int8 flags are ported (tests/test_torch_quant_cli.py); cc refuses them.
    assert (args.quantized, args.quant_mode, args.calib_batches, args.calib_batch_size) == (
        False, "dynamic", 8, 8)
    with pytest.raises(SystemExit, match="--quantized applies to the detection tasks"):
        cli.main(["export", "--model_task", "cc", "--checkpoint", "c", "--out", "x",
                  "--quantized", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(base)
