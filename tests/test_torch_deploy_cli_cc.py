"""The CC half of the port's deploy CLI and ``cli info`` on the CPU: ``cli
eval --model_task cc`` of a trained TINY CC run equals the run's final
report (and writes res.json / gts.json with --save_json); on bridged weights
``run_caption_eval`` equals JAX's within 1e-6; ``cli predict --model_task cc``
writes the captions of a direct ``CaptionPredictor``; ``cli info``'s
parameter counts equal JAX ``model_info``'s exactly for every task and its
FLOPs come within 10% (the gap: ``utils/model_info.py``'s docstring);
``cli convert-reference --model_task cc`` reads the decoder's geometry from
the weights."""

import json
import os

import numpy as np
import pytest
import torch

from change3d_tpu.checkpoint.orbax_io import CheckpointManager as JaxCheckpointManager
from change3d_tpu.models.x3d import x3d_l_config as jax_x3d_l_config
from change3d_tpu.train import caption_loop as jax_caption_loop
from change3d_tpu.utils.model_info import model_info as jax_model_info
from change3d_tpu_torch import cli
from change3d_tpu_torch.checkpoint.io import CheckpointManager, restore_best_state
from change3d_tpu_torch.data.datasets import CaptionDataset
from change3d_tpu_torch.inference import CaptionPredictor
from change3d_tpu_torch.train import caption_loop
from change3d_tpu_torch.utils.model_info import model_info

from tests._tiny_cc import VOCAB
from tests.test_convert_reference import make_trainer_sd
from tests.test_torch_cc_loop import (  # noqa: F401
    HW,
    _argv,
    _run_dir,
    _two_threads,
    data_root,
    tiny_model,
)
from tests.test_torch_cc_model import cc_pair


def _cc_argv(sub, run_dir, root, *extra):
    return [sub, "--model_task", "cc", "--checkpoint", run_dir, "--file_root", root,
            "--dataset", "DS", "--device", "cpu", "--batch_size", "3", "--n_head", "4",
            "--n_layer", "2", "--beam_size", "2", *extra]


def test_cc_eval_equals_the_training_report(data_root, tmp_path, tiny_model, capsys):
    save = str(tmp_path / "run")
    res = cli.main(_argv(data_root, save, 2))
    capsys.readouterr()
    run_dir = _run_dir(save)
    for name in ("res.json", "gts.json"):
        os.remove(os.path.join(run_dir, name))
    assert cli.main(_cc_argv("eval", run_dir, data_root, "--num_workers", "2", "--json",
                             "--save_json")) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res["test_best"]
    assert all(os.path.exists(os.path.join(run_dir, n)) for n in ("res.json", "gts.json"))

    out = str(tmp_path / "captions")
    assert cli.main(_cc_argv("predict", run_dir, data_root, "--out", out,
                             "--compute_dtype", "float32")) == 0
    with open(os.path.join(out, "captions.json")) as f:
        written = json.load(f)
    model = caption_loop.build_caption_model(
        caption_loop.CaptionRunConfig(n_head=4, n_layer=2, device="cpu"), len(VOCAB), HW)
    pred = CaptionPredictor.from_checkpoint(model, run_dir, word_map=VOCAB, beam_size=2,
                                            compute_dtype=torch.float32, device="cpu")
    ds = CaptionDataset(data_root, "DS", "TEST")
    rows = [ds[i] for i in range(len(ds)) if (i + 1) % ds.cpi == 0]
    want = pred.caption(np.stack([r["pre"] for r in rows]), np.stack([r["post"] for r in rows]))
    assert written == [{"image_id": i, "caption": c} for i, c in enumerate(want)]


def test_run_caption_eval_matches_jax(data_root, tmp_path, monkeypatch):
    jmodel, variables, model = cc_pair(True, seed=17, hw=HW, vocab_size=len(VOCAB))
    JaxCheckpointManager(str(tmp_path / "jax")).save_best(variables)
    CheckpointManager(str(tmp_path / "port")).save_best(model)
    monkeypatch.setattr(jax_caption_loop, "build_caption_model", lambda *a, **k: jmodel)
    monkeypatch.setattr(caption_loop, "build_caption_model", lambda *a, **k: model)
    kw = dict(file_root=data_root, dataset="DS", n_head=4, n_layer=2, beam_size=2,
              eval_batch_size=4, num_workers=2)
    want = jax_caption_loop.run_caption_eval(jax_caption_loop.CaptionRunConfig(**kw),
                                             run_dir=str(tmp_path / "jax"))
    got = caption_loop.run_caption_eval(caption_loop.CaptionRunConfig(**kw, device="cpu"),
                                        run_dir=str(tmp_path / "port"))
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - float(v)) <= 1e-6, (k, got[k], v)


@pytest.mark.parametrize("task", ["bcd", "scd", "bda", "cc"])
def test_info_counts_equal_jax(task, capsys):
    want = jax_model_info(task, in_height=64, in_width=64)
    assert cli.main(["info", "--model_task", task, "--in_height", "64", "--in_width", "64",
                     "--device", "cpu", "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    for key in ("task", "input", "params_total", "params_excl_perception", "params_breakdown"):
        assert got[key] == want[key], key
    assert abs(got["flops_per_sample"] / want["flops_per_sample"] - 1) <= 0.10
    assert got["macs_per_sample"] == got["flops_per_sample"] / 2


def test_info_at_256_carries_the_published_row():
    report = model_info("bcd", device="cpu")
    assert report["reference"]["params_m"] == 1.54 and report["params_m"] == round(
        report["params_excl_perception"] / 1e6, 3)
    assert report["gmacs"] == round(report["flops_per_sample"] / 2e9, 3)


def test_convert_reference_reads_the_caption_decoder_geometry(tmp_path, capsys):
    """The vocabulary, width and depth of a reference CC checkpoint come from
    its weights (the JAX CLI reads the depth from the wrong key field)."""
    sd = make_trainer_sd("cc", 1, cfg=jax_x3d_l_config(), hw=(32, 32), vocab=11, embed=192,
                         layers=2)
    torch.save(sd, str(tmp_path / "best_model.pth"))
    assert cli.main(["convert-reference", "--model_task", "cc", "--torch_checkpoint",
                     str(tmp_path / "best_model.pth"), "--out", str(tmp_path / "run"),
                     "--in_height", "32", "--in_width", "32", "--device", "cpu"]) == 0
    assert "vocab_size=11 embed_dim=192 n_layer=2" in capsys.readouterr().out
    state = restore_best_state(str(tmp_path / "run"))
    assert state["decoder.vocab_embedding"].shape == (11, 192)
    assert torch.equal(state["decoder.layer1.norm2.scale"],
                       sd["decoder.transformer.layers.1.norm2.weight"])
