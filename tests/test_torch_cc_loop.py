"""CC data and loop of change3d_tpu_torch on the CPU: ``CaptionDataset``,
``_EveryFifth`` and ``caption_collate`` against the JAX package's on
tests/_tiny_cc.py's HDF5 + JSON data; ``evaluate_captions``' change /
no-change split and saved JSON against the JAX function on the same
hypotheses; ``python -m change3d_tpu_torch.cli cc --device cpu`` for two
epochs with a TINY backbone (logs, checkpoints, the BLEU-4 gate, the
best-model re-evaluation); and a run preempted mid-epoch and one on an
epoch boundary that resume to the bit-identical end state of an
uninterrupted run."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from change3d_tpu.data.datasets import CaptionDataset as JaxCaptionDataset
from change3d_tpu.data.pipeline import caption_collate as jax_caption_collate
from change3d_tpu.train import caption_loop as jax_caption_loop
from change3d_tpu_torch import cli
from change3d_tpu_torch.data.datasets import CaptionDataset
from change3d_tpu_torch.data.pipeline import caption_collate, make_data_loader
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import X3DConfig
from change3d_tpu_torch.train import caption_loop

from tests._tiny_cc import TINY_KW, write_caption_dataset
from tests.test_torch_train_loop import _assert_bit_identical

HW = 32
BACKBONE = {k: TINY_KW[k] for k in ("stem_dim_out", "stage_dims", "stage_inner_dims",
                                    "stage_depths")}


@pytest.fixture(autouse=True)
def _two_threads():
    """The decode runs thousands of tiny ops; under a parallel test run
    many intra-op threads per process only contend for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """4 images x 5 captions per split: 20 train rows (2 batches of 8 per
    epoch), 4 eval images."""
    root = str(tmp_path_factory.mktemp("levir_cc"))
    write_caption_dataset(root, n_imgs=4, cpi=5, cap_len=12, hw=HW)
    return root


@pytest.fixture
def tiny_model(monkeypatch):
    def build(cfg, vocab_size, in_size=256, backbone_cfg=None):
        return Change3D(Task.CC, in_height=in_size, in_width=in_size,
                        backbone_cfg=X3DConfig(**BACKBONE), vocab_size=vocab_size,
                        embed_dim=BACKBONE["stage_dims"][3], num_heads=cfg.n_head,
                        num_layers=cfg.n_layer, dropout=cfg.dropout, device=cfg.device,
                        generator=torch.Generator().manual_seed(cfg.seed))

    monkeypatch.setattr(caption_loop, "build_caption_model", build)
    monkeypatch.delenv("CHANGE3D_PREEMPT_AFTER_STEP", raising=False)


def _argv(root, save_dir, epochs, *extra):
    return ["cc", "--file_root", root, "--dataset", "DS", "--save_dir", save_dir,
            "--device", "cpu", "--batch_size", "8", "--eval_batch_size", "3",
            "--num_workers", "2", "--epochs", str(epochs), "--n_head", "4", "--n_layer", "2",
            "--lr", "1e-3", "--beam_size", "2", *extra]


def _run_dir(save_dir):
    return os.path.join(save_dir, "DS_cc_lr_0.001")


def _final_state(save_dir):
    ckpt = os.path.join(_run_dir(save_dir), "ckpt")
    step = max(int(d) for d in os.listdir(ckpt) if d.isdigit())
    return step, torch.load(os.path.join(ckpt, str(step), "state.pt"))


def _logged(save_dir, split="val"):
    with open(os.path.join(_run_dir(save_dir), "train_val_log.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [r for r in rows if r.get("event") == "epoch" and r["split"] == split]


@pytest.mark.parametrize("split", ["TRAIN", "TEST"])
def test_caption_dataset_and_collate_match_jax(data_root, split):
    ours, theirs = CaptionDataset(data_root, "DS", split), JaxCaptionDataset(data_root, "DS", split)
    assert len(ours) == len(theirs) == 20 and ours.cpi == theirs.cpi == 5
    for idx in (0, 4, 7, 19):
        for seed in range(4):  # the p = 0.3 swap on and off
            a = ours.__getitem__(idx, np.random.default_rng(seed))
            b = theirs.__getitem__(idx, np.random.default_rng(seed))
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    view, jview = caption_loop._EveryFifth(ours), jax_caption_loop._EveryFifth(theirs)
    assert view.idxs == jview.idxs == [4, 9, 14, 19]
    samples = [view.__getitem__(i, np.random.default_rng(i)) for i in range(3)]
    jsamples = [jview.__getitem__(i, np.random.default_rng(i)) for i in range(3)]
    got, want = caption_collate(samples), jax_caption_collate(jsamples)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ours.close()
    theirs.close()


def test_train_loader_swaps_pairs_from_the_sample_generator(data_root):
    """The swap draws from the loader's per-sample generator: two epochs
    with one seed give the same batches, and some pairs come swapped."""
    data = CaptionDataset(data_root, "DS", "TRAIN")
    loader = make_data_loader("threaded", data, 8, shuffle=True, seed=3, num_workers=2,
                              collate=caption_collate, drop_last=True)
    first, again = list(loader), list(loader)
    for a, b in zip(first, again):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    raw = [data.__getitem__(i, np.random.default_rng(99)) for i in range(20)]
    pres, posts = {r["pre"].tobytes() for r in raw}, {r["post"].tobytes() for r in raw}
    got = [row.tobytes() for batch in first for row in batch["pre"]]
    assert all(p in pres | posts for p in got)
    assert any(p in posts for p in got) and any(p in pres for p in got)  # some swapped
    data.close()


def test_evaluate_captions_split_and_json_match_jax(tmp_path):
    """The same decoded tokens through both packages' evaluate_captions:
    every metric, change_acc / nochange_acc and the res/gts JSON agree."""
    words = {"<pad>": 0, "<start>": 1, "<end>": 2}
    for w in "the scene is same as before a road appeared there no difference".split():
        words.setdefault(w, len(words))
    enc = lambda s: [1] + [words[w] for w in s.split()] + [2]
    nochange, change = "the scene is the same as before", "a road appeared"
    refs = [[enc(nochange)] * 5, [enc(change)] * 5, [enc(change)] * 5, [enc(nochange)] * 5]
    hyps = [enc(nochange), enc(change), enc(nochange), enc("there is no difference")]
    width = 12
    pad = lambda seq: seq + [0] * (width - len(seq))
    batch = {"pre": np.zeros((4, 2, 2, 3), np.float32), "post": np.zeros((4, 2, 2, 3), np.float32),
             "all_captions": np.asarray([[pad(r) for r in rr] for rr in refs], np.int32),
             "valid": np.ones(4, bool)}
    tokens = np.asarray([pad(h) for h in hyps], np.int64)

    torch_decode = lambda pre, post: (torch.from_numpy(tokens), torch.zeros(4))
    got = caption_loop.evaluate_captions(torch.nn.Linear(1, 1), [dict(batch)], words,
                                         save_dir=str(tmp_path / "ours"), decode_fn=torch_decode)
    jax_decode = lambda variables, pre, post: (tokens, np.zeros(4))
    want = jax_caption_loop.evaluate_captions(None, None, [dict(batch)], words,
                                              save_dir=str(tmp_path / "jax"),
                                              decode_fn=jax_decode)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k
    assert got["change_acc"] == 0.5 and got["nochange_acc"] == 1.0
    for name in ("res.json", "gts.json"):
        with open(tmp_path / "ours" / name) as f, open(tmp_path / "jax" / name) as g:
            assert json.load(f) == json.load(g)


def test_cli_cc_trains_evaluates_and_checkpoints(data_root, tmp_path, tiny_model):
    save = str(tmp_path / "run")
    res = cli.main(_argv(data_root, save, 2))
    run_dir = _run_dir(save)
    for name in ("train_val_log.jsonl", "best/model.pt", "ckpt/train_meta.json", "res.json",
                 "gts.json"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    # CC evaluates every epoch, 0 included, then the best model.
    assert [r["epoch"] for r in _logged(save)] == [0, 1]
    assert len(_logged(save, "test_best")) == 1
    assert res["steps"] == 4
    assert set(res["test_best"]) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                                     "ROUGE_L", "CIDEr", "change_acc", "nochange_acc"}
    with open(os.path.join(run_dir, "ckpt", "train_meta.json")) as f:
        assert json.load(f)["best_val"] == max(r["Bleu_4"] for r in _logged(save))
    with open(os.path.join(run_dir, "res.json")) as f:
        assert len(json.load(f)) == 4  # one hypothesis per eval image, padding dropped
    assert sorted(d for d in os.listdir(os.path.join(run_dir, "ckpt")) if d.isdigit()) == ["2", "4"]
    res2 = cli.main(_argv(data_root, save, 2, "--resume"))
    assert res2["resumed_from_step"] == 4 and res2["steps"] == 4
    assert res2["test_best"] == res["test_best"]


@pytest.mark.parametrize("preempt_at", [3, 2], ids=["mid_epoch", "boundary"])
def test_preempted_cc_run_resumes_bit_identically(data_root, tmp_path, tiny_model, monkeypatch,
                                                  preempt_at):
    straight, killed = str(tmp_path / "straight"), str(tmp_path / "killed")
    res_a = cli.main(_argv(data_root, straight, 2))
    monkeypatch.setenv("CHANGE3D_PREEMPT_AFTER_STEP", str(preempt_at))
    res_b = cli.main(_argv(data_root, killed, 2))
    assert res_b["preempted_at_step"] == preempt_at
    monkeypatch.delenv("CHANGE3D_PREEMPT_AFTER_STEP")
    res_c = cli.main(_argv(data_root, killed, 2, "--resume"))
    assert res_c["resumed_from_step"] == preempt_at and "preempted_at_step" not in res_c
    step_a, state_a = _final_state(straight)
    step_c, state_c = _final_state(killed)
    assert step_a == step_c == 4
    _assert_bit_identical(state_a, state_c)  # parameters, BN stats, optimizer, step
    assert [r["epoch"] for r in _logged(killed)] == [0, 1]
    assert res_a["last"] == res_c["last"] and res_a["test_best"] == res_c["test_best"]


def test_cli_cc_defaults_and_refusals(data_root, tmp_path, capsys):
    args = cli.build_parser().parse_args(["cc", "--file_root", "r"])
    assert (args.device, args.batch_size, args.eval_batch_size, args.lr, args.compute_dtype,
            args.grad_clip, args.beam_size, args.fine_tune_encoder, args.dropout) == (
        "cuda", 32, 32, 1e-4, "float32", 5.0, 1, True, 0.1)
    assert cli.build_parser().parse_args(
        ["cc", "--file_root", "r", "--no-fine_tune_encoder"]).fine_tune_encoder is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["cc", "--file_root", data_root, "--dataset", "DS",
                      "--save_dir", str(tmp_path / "x")])
    with pytest.raises(SystemExit):
        cli.main(["cc", "--file_root", data_root, "--packed", "x"])
    err = capsys.readouterr().err
    assert "--packed is not ported yet" in err and "never ported" in err
    # --loader is ported: grain (the worker-process loader) parses, and an
    # unknown kind is refused.
    assert cli.build_parser().parse_args(["cc", "--file_root", "r", "--loader", "grain"]
                                         ).loader == "grain"
    with pytest.raises(SystemExit):
        cli.main(["cc", "--file_root", data_root, "--loader", "bogus"])
    assert "invalid choice: 'bogus'" in capsys.readouterr().err
    # --remat parses and does nothing for cc, as in the JAX CLI.
    assert cli.build_parser().parse_args(["cc", "--file_root", "r", "--remat"]).remat
    assert "remat" not in {f.name for f in dataclasses.fields(cli.CaptionRunConfig)}
    # The multi-process flags are ported: they parse.
    args = cli.build_parser().parse_args(["cc", "--file_root", "r", "--coordinator_address",
                                          "127.0.0.1:1", "--num_processes", "2",
                                          "--process_id", "0"])
    assert (args.coordinator_address, args.num_processes, args.process_id) == (
        "127.0.0.1:1", 2, 0)
