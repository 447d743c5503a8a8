"""``tools/jax_run_to_torch.py``: a TINY run saved by the JAX package's
``CheckpointManager`` (``save_best`` and a training step) is converted at
``best`` and at ``latest``; the port's ``Predictor`` on the written run
gives the JAX ``Predictor``'s probabilities within 1e-5 (fp32) and equal
masks, and a TINY CC run gives equal beam-1 tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.checkpoint.orbax_io import CheckpointManager as JaxCheckpointManager
from change3d_tpu.inference import (
    CaptionPredictor as JaxCaptionPredictor,
    Predictor as JaxPredictor,
)
from change3d_tpu.models.trainer import Change3D as JaxChange3D, Task as JaxTask
from change3d_tpu.models.x3d import X3DConfig as JaxX3DConfig
from change3d_tpu_torch.inference import CaptionPredictor, Predictor
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import X3DConfig
from tests.test_torch_cc_model import DECODER_KW, TINY_CC, jax_cc, random_vars
from tools import jax_run_to_torch as tool

HW = 32
TINY = dict(TINY_CC, stage_depths=(2, 3, 3, 1))
WORDS = {"<pad>": 0, "<unk>": 1, "<start>": 2, "<end>": 3}
WORDS.update({f"w{i}": i for i in range(4, DECODER_KW["vocab_size"])})


def _save_jax_run(run, best, latest, step=3):
    """What the JAX training loop leaves: best/ and ckpt/{step}."""
    mgr = JaxCheckpointManager(str(run))
    mgr.save_best(best)
    mgr.save(step, {"params": latest["params"], "batch_stats": latest["batch_stats"],
                    "step": np.int32(step)})
    mgr.wait()


def _abstract_init(jmodel):
    """``restore_best_variables`` builds its template by an eager ``init``
    of the model, about 25 s for a TINY model on a CPU; the restore needs
    only the template's shapes, which ``jax.eval_shape`` gives at once."""
    init = jmodel.init
    object.__setattr__(jmodel, "init", lambda *a, **kw: jax.eval_shape(init, *a, **kw))
    return jmodel


def _detection_pair(task, num_class):
    jmodel = JaxChange3D(task=JaxTask(task), num_classes=num_class, in_height=HW, in_width=HW,
                         backbone_cfg=JaxX3DConfig(**TINY))
    model = Change3D(Task(task), num_classes=num_class, in_height=HW, in_width=HW,
                     backbone_cfg=X3DConfig(**TINY), device="cpu")
    z = jnp.zeros((1, HW, HW, 3), jnp.float32)
    init = lambda key: jmodel.init(key, z, z)
    best, latest = random_vars(init, seed=1), random_vars(init, seed=2)
    return _abstract_init(jmodel), model, best, latest


@pytest.mark.parametrize("task,num_class", [("bcd", 1), ("scd", 6)])
def test_detection_run_best_and_latest(tmp_path, task, num_class):
    jmodel, model, best, latest = _detection_pair(task, num_class)
    run = tmp_path / "jax_run"
    _save_jax_run(run, best, latest)
    rs = np.random.RandomState(7)
    pre, post = (rs.randn(3, HW, HW, 3).astype(np.float32) for _ in range(2))
    for which, variables in (("best", best), ("latest", latest)):
        out = tmp_path / f"port_{which}"
        args = tool.parse_args(["--model_task", task, "--run", str(run), "--out", str(out),
                                "--which", which, "--num_class", str(num_class),
                                "--in_height", str(HW), "--in_width", str(HW)])
        assert tool.convert(args, models=(jmodel, model)) == str(out / "best" / "model.pt")
        fresh = Change3D(Task(task), num_classes=num_class, in_height=HW, in_width=HW,
                         backbone_cfg=X3DConfig(**TINY), device="cpu", seed=99)
        pred = Predictor.from_checkpoint(fresh, str(out), compute_dtype=torch.float32,
                                         device="cpu")
        jpred = JaxPredictor(jmodel, variables, compute_dtype=jnp.float32)
        got, want = pred.predict_probs(pre, post), jpred.predict_probs(pre, post)
        assert got.keys() == want.keys()
        for k in want:
            err = float(np.abs(got[k] - want[k]).max())
            assert err <= 1e-5, (which, k, err)
        hard_got, hard_want = pred.predict(pre, post), jpred.predict(pre, post)
        for k in hard_want:
            np.testing.assert_array_equal(hard_got[k], hard_want[k])
    # best and latest are different weights, and each was converted as itself.
    a = torch.load(tmp_path / "port_best" / "best" / "model.pt")
    b = torch.load(tmp_path / "port_latest" / "best" / "model.pt")
    assert any(not torch.equal(a[k], b[k]) for k in a)


def test_cc_run_gives_the_jax_tokens(tmp_path):
    jcfg = JaxX3DConfig(**TINY_CC)
    jmodel = jax_cc(jcfg)
    z = jnp.zeros((1, HW, HW, 3), jnp.float32)
    variables = random_vars(lambda key: jmodel.init(key, z, z, captions=jnp.zeros((1, 4),
                                                                                 jnp.int32)),
                            seed=13)
    variables["params"]["decoder"]["out_b"][3] -= 2.0  # captions end inside the length
    variables["params"]["decoder"]["out_w"][:, 3] *= 3.0
    run = tmp_path / "jax_cc"
    _save_jax_run(run, variables, variables)
    _abstract_init(jmodel)
    model = Change3D(Task.CC, in_height=HW, in_width=HW, backbone_cfg=X3DConfig(**TINY_CC),
                     device="cpu", **DECODER_KW)
    wm = tmp_path / "WORDMAP.json"
    wm.write_text(__import__("json").dumps(WORDS))
    args = tool.parse_args(["--model_task", "cc", "--run", str(run), "--out",
                            str(tmp_path / "port_cc"), "--word_map", str(wm), "--embed_dim",
                            str(DECODER_KW["embed_dim"]), "--n_head",
                            str(DECODER_KW["num_heads"]), "--n_layer",
                            str(DECODER_KW["num_layers"]), "--in_height", str(HW),
                            "--in_width", str(HW)])
    assert args.vocab_size == len(WORDS)
    tool.convert(args, models=(jmodel, model))
    fresh = Change3D(Task.CC, in_height=HW, in_width=HW, backbone_cfg=X3DConfig(**TINY_CC),
                     device="cpu", seed=5, **DECODER_KW)
    pred = CaptionPredictor.from_checkpoint(fresh, str(tmp_path / "port_cc"), word_map=WORDS,
                                            beam_size=1, compute_dtype=torch.float32,
                                            device="cpu")
    jpred = JaxCaptionPredictor(jmodel, jax.tree_util.tree_map(jnp.asarray, variables), WORDS,
                                beam_size=1, compute_dtype=jnp.float32)
    rs = np.random.RandomState(14)
    pre, post = (rs.randint(0, 256, (3, HW, HW, 3)).astype(np.uint8) for _ in range(2))
    want = jpred.caption_u8(pre, post)
    assert pred.caption_u8(pre, post) == want
    assert all(want)  # every caption has words


def test_the_model_flags_must_match_the_run(tmp_path):
    jmodel, model, best, latest = _detection_pair("bcd", 1)
    run = tmp_path / "jax_run"
    _save_jax_run(run, best, latest)
    wrong = Change3D(Task.BCD, in_height=HW, in_width=HW,
                     backbone_cfg=X3DConfig(**dict(TINY, stage_depths=(2, 3, 2, 1))),
                     device="cpu")
    args = tool.parse_args(["--model_task", "bcd", "--run", str(run), "--out",
                            str(tmp_path / "o"), "--which", "latest"])
    with pytest.raises(ValueError, match="do not match depth"):
        tool.convert(args, models=(jmodel, wrong))
    with pytest.raises(SystemExit):
        tool.parse_args(["--model_task", "cc", "--run", "r", "--out", "o"])
