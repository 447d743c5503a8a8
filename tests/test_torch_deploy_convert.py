"""The port's reference-checkpoint converters against the JAX package's, on
the synthetic reference files of ``tests/test_convert_reference.py`` (a
``Trainer`` state_dict per task) and ``tests/torch_oracle.py`` (a Kinetics
X3D) with the TINY backbone: ``convert_trainer_state_dict`` and
``load_x3d_pretrained`` give exactly what the JAX converters give once
bridged by ``from_jax_variables``; the converted models' fp32 forwards agree
within 1e-5 of the outputs' max; an unknown key and a missing entry raise;
``merge_backbone_variables`` fills exactly the model's backbone entries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.checkpoint.convert import (
    convert_trainer_state_dict as jax_convert_trainer,
    load_x3d_pretrained as jax_load_x3d,
    merge_backbone_variables as jax_merge,
)
from change3d_tpu_torch.checkpoint.convert import (
    convert_trainer_state_dict,
    from_jax_variables,
    load_trainer_pretrained,
    load_x3d_pretrained,
    merge_backbone_variables,
)
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import X3DConfig

from tests.test_convert_reference import H, TINY_CFG, W, _model, _template, make_trainer_sd
from tests.torch_oracle import make_random_x3d_state_dict

PCFG = X3DConfig(stem_dim_out=TINY_CFG.stem_dim_out, stage_dims=TINY_CFG.stage_dims,
                 stage_inner_dims=TINY_CFG.stage_inner_dims, stage_depths=TINY_CFG.stage_depths)
NUM_CLASSES = {"bcd": 1, "scd": 6, "bda": 5, "cc": 1}
CC = dict(vocab=11, embed=TINY_CFG.stage_dims[-1], layers=2)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model(task):
    kw = (dict(vocab_size=CC["vocab"], embed_dim=CC["embed"], num_heads=4,
               num_layers=CC["layers"]) if task == "cc" else {})
    return Change3D(Task(task), num_classes=NUM_CLASSES[task], in_height=H, in_width=W,
                    backbone_cfg=PCFG, device="cpu", **kw).eval()


def _jax_side(task):
    kw = (dict(vocab_size=CC["vocab"], embed_dim=CC["embed"], num_heads=4,
               num_layers=CC["layers"]) if task == "cc" else {})
    model = _model(task, NUM_CLASSES[task], **kw)
    return model, _template(model, task)


def _trainer_sd(task):
    return make_trainer_sd(task, NUM_CLASSES[task], **(CC if task == "cc" else {}))


def _assert_equal_state(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("task", ["bcd", "scd", "bda", "cc"])
def test_trainer_conversion_equals_bridged_jax_and_forwards_agree(task):
    sd = _trainer_sd(task)
    jmodel, template = _jax_side(task)
    jvars = jax_convert_trainer(sd, template, TINY_CFG)
    model = _port_model(task)
    got = convert_trainer_state_dict(sd, model.state_dict(), PCFG)
    _assert_equal_state(got, from_jax_variables(_numpy(jvars), PCFG))
    assert set(got) == set(model.state_dict())
    model.load_state_dict(got, strict=True)

    rs = np.random.RandomState(7)
    pre, post = (rs.randn(2, H, W, 3).astype(np.float32) for _ in range(2))
    caps = np.asarray([[2, 4, 5, 3], [2, 6, 7, 3]], np.int32)
    extra = {"captions": caps} if task == "cc" else {}
    want = jmodel.apply(jvars, jnp.asarray(pre), jnp.asarray(post), train=False,
                        **{k: jnp.asarray(v) for k, v in extra.items()})
    with torch.no_grad():
        out = model(torch.from_numpy(pre), torch.from_numpy(post),
                    **{k: torch.from_numpy(v).long() for k, v in extra.items()})
    assert set(out) == set(want)
    for key in want:
        w = np.asarray(want[key])
        err = np.abs(out[key].numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (key, err, np.abs(w).max())


def test_trainer_file_in_both_formats(tmp_path):
    """best_model.pth (the bare state_dict) and checkpoint.pth.tar (under
    'state_dict') load to the same weights."""
    sd = _trainer_sd("bda")
    model = _port_model("bda")
    torch.save(sd, tmp_path / "best_model.pth")
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "checkpoint.pth.tar")
    a = load_trainer_pretrained(str(tmp_path / "best_model.pth"), model.state_dict(), PCFG)
    b = load_trainer_pretrained(str(tmp_path / "checkpoint.pth.tar"), model.state_dict(), PCFG)
    _assert_equal_state(a, b)
    _assert_equal_state(a, convert_trainer_state_dict(sd, model.state_dict(), PCFG))


@pytest.mark.parametrize("edit, match", [("unknown", "unmapped"), ("missing", "missing"),
                                         ("backbone_missing", "missing"),
                                         ("backbone_unknown", "unmapped"),
                                         ("shape", "shape mismatch")])
def test_trainer_conversion_is_strict(edit, match):
    sd = _trainer_sd("bcd")
    if edit == "unknown":
        sd["decoder.mystery.weight"] = torch.zeros(3)
    elif edit == "missing":
        del sd["decoder.up_c4.1.bias"]
    elif edit == "backbone_missing":
        del sd["encoder.x3d.blocks.2.res_blocks.0.branch2.conv_b.weight"]
    elif edit == "backbone_unknown":
        sd["encoder.x3d.blocks.9.mystery"] = torch.zeros(1)
    else:
        sd["decoder.up_c1.0.weight"] = torch.zeros(2, TINY_CFG.stem_dim_out, 3, 3)
    with pytest.raises(ValueError, match=match):
        convert_trainer_state_dict(sd, _port_model("bcd").state_dict(), PCFG)


@pytest.fixture(scope="module")
def pyth(tmp_path_factory):
    path = tmp_path_factory.mktemp("x3d") / "X3D_L.pyth"
    torch.save({"model_state": make_random_x3d_state_dict(TINY_CFG, seed=5), "epoch": 0},
               str(path))
    return str(path)


def test_x3d_pretrained_equals_bridged_jax(pyth):
    got = load_x3d_pretrained(pyth, PCFG)
    jvars = _numpy(jax_load_x3d(pyth, TINY_CFG))
    body = {k: v for k, v in got.items() if not k.startswith("head.")}
    _assert_equal_state(body, from_jax_variables(jvars, PCFG))
    # The Kinetics head, which the bridge drops: [in, out] matrices as JAX keeps them.
    jhead = {}
    for collection in ("params", "batch_stats"):
        for k, v in jvars[collection]["head"].items():
            jhead.update({f"{k}.{kk}": vv for kk, vv in v.items()} if isinstance(v, dict)
                         else {k: v})
    head = {k[len("head."):]: v for k, v in got.items() if k.startswith("head.")}
    assert set(head) == set(jhead)
    for k, v in jhead.items():
        np.testing.assert_array_equal(head[k].numpy(), v, err_msg=k)


def test_x3d_pretrained_is_strict(tmp_path):
    sd = make_random_x3d_state_dict(TINY_CFG, seed=5)
    sd.pop("blocks.5.proj.bias")
    torch.save({"model_state": sd}, str(tmp_path / "a.pyth"))
    with pytest.raises(ValueError, match="missing"):
        load_x3d_pretrained(str(tmp_path / "a.pyth"), PCFG)
    sd = make_random_x3d_state_dict(TINY_CFG, seed=5)
    sd["blocks.1.res_blocks.0.extra.weight"] = torch.zeros(1)
    torch.save({"model_state": sd}, str(tmp_path / "b.pyth"))
    with pytest.raises(ValueError, match="unmapped"):
        load_x3d_pretrained(str(tmp_path / "b.pyth"), PCFG)


@pytest.mark.parametrize("task", ["bcd", "cc"])
def test_merge_backbone_equals_jax_on_the_model_entries(pyth, task):
    model = _port_model(task)
    merged = merge_backbone_variables(model.state_dict(), load_x3d_pretrained(pyth, PCFG))
    assert set(merged) == set(model.state_dict())  # no stage 4 for bcd, no head
    _, template = _jax_side(task)
    jmerged = from_jax_variables(_numpy(jax_merge(template, jax_load_x3d(pyth, TINY_CFG))),
                                 PCFG)
    for k, v in merged.items():
        want = jmerged[k] if k.startswith("encoder.x3d.") else model.state_dict()[k]
        assert torch.equal(v, want), k
    model.load_state_dict(merged, strict=True)


def test_merge_backbone_refuses_a_short_backbone(pyth):
    backbone = load_x3d_pretrained(pyth, PCFG)
    backbone.pop("stage2.block0.proj")
    with pytest.raises(ValueError, match="lacks"):
        merge_backbone_variables(_port_model("bcd").state_dict(), backbone)
