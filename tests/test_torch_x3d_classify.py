"""The port's X3D Kinetics classifier (``X3D(cfg, head=True)``,
``forward(x, classify=True)``, ``x3d_m_config``, ``X3DHead``) held against
the JAX ``X3D(x3d_m_config())`` with ``classify=True`` on the same seeded
weights (bridged by ``from_jax_variables(..., head=True)``), in fp32 on the
CPU: eval logits and every stage's features within 1e-4 absolute on 16-,
13- and 4-frame clips at 32² (the port through its fused path's plain
versions; before the temporal tile a 16-frame clip raised ValueError in the
tile planner), and one train-mode step with dropout off (logits and BN
batch statistics). Also the parameter counts, the head's conversion paths
and the dropout generator."""

import dataclasses
import functools
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from change3d_tpu.checkpoint.convert import load_x3d_pretrained as jax_load_x3d
from change3d_tpu.models.x3d import (
    X3D as JaxX3D,
    X3DStage as JaxX3DStage,
    X3DStem as JaxX3DStem,
    x3d_l_config as jax_x3d_l_config,
    x3d_m_config as jax_x3d_m_config,
)
from change3d_tpu_torch.checkpoint.convert import (
    from_jax_variables,
    load_x3d_pretrained,
    merge_backbone_variables,
)
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import (
    X3D,
    X3DConfig,
    x3d_classifier,
    x3d_l_config,
    x3d_m_config,
)

from tests.test_convert_reference import TINY_CFG
from tests.torch_oracle import make_random_x3d_state_dict, oracle_head, oracle_run_blocks

ATOL = 1e-4
HW, BATCH = 32, 2
STAGE_NAMES = ("stem", "stage1", "stage2", "stage3", "stage4")
PCFG = X3DConfig(stem_dim_out=TINY_CFG.stem_dim_out, stage_dims=TINY_CFG.stage_dims,
                 stage_inner_dims=TINY_CFG.stage_inner_dims, stage_depths=TINY_CFG.stage_depths,
                 head_dim_out=TINY_CFG.head_dim_out, num_classes=TINY_CFG.num_classes)


@pytest.fixture(autouse=True)
def few_threads():
    """Two torch threads: under the six-worker test run more only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _count(tree) -> int:
    return sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(tree))


def _seeded_tree(module, seed, t=4):
    """The JAX X3D's variables (head included), shapes from ``eval_shape``
    of its init, filled from a numpy seed: kernels U(+-sqrt(3 / fan_in)) so
    activations keep their scale through all 26 blocks, BN statistics,
    scales and biases away from their trivial init."""
    shapes = jax.eval_shape(partial(module.init, classify=True), jax.random.PRNGKey(0),
                            jnp.zeros((BATCH, t, HW, HW, 3), jnp.float32))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "var":
            return (1.0 + 0.5 * rng.rand(*shape)).astype(np.float32)
        if name in ("bias", "mean", "b_reduce", "b_expand", "proj_b"):
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        stacked = any(getattr(p, "key", None) == "pairs" for p in path)
        fan_in = int(np.prod(shape[1 if stacked else 0:-1]))
        return (rng.uniform(-1, 1, shape) * np.sqrt(3.0 / fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def m_pair():
    """(JAX X3D-M, its seeded variables, the port's X3D-M with the head
    holding them, in eval mode)."""
    jmodel = JaxX3D(jax_x3d_m_config())
    variables = _seeded_tree(jmodel, seed=0)
    model = X3D(x3d_m_config(), head=True)
    model.load_state_dict(from_jax_variables(variables, x3d_m_config(), head=True), strict=True)
    return jmodel, variables, model.eval()


def _stage_filter(mdl, name):
    return name == "__call__" and isinstance(mdl, (JaxX3DStem, JaxX3DStage))


def _clip(t, seed):
    return np.random.RandomState(seed).randn(BATCH, t, HW, HW, 3).astype(np.float32)


def test_x3d_m_config_equals_jax():
    jcfg, cfg = jax_x3d_m_config(), x3d_m_config()
    for f in dataclasses.fields(X3DConfig):
        if hasattr(jcfg, f.name) and f.name != "fused_inference":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.stage_depths == (3, 5, 11, 7) and cfg.stem_conv_stride == (1, 2, 2)
    assert (cfg.head_dim_out, cfg.num_classes, cfg.dropout_rate) == (2048, 400, 0.5)


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(variant):
    """The JAX X3D-M ('m') or X3D-L ('l') classifier's parameter shapes."""
    jcfg = jax_x3d_m_config() if variant == "m" else jax_x3d_l_config()
    return jax.eval_shape(partial(JaxX3D(jcfg).init, classify=True), jax.random.PRNGKey(0),
                          jnp.zeros((1, 4, 16, 16, 3), jnp.float32))["params"]


@pytest.mark.parametrize("which, want", [("m_head", 3_794_274), ("l_head", 6_153_384),
                                         ("l_backbone", 4_365_240)])
def test_parameter_counts_equal_jax(which, want):
    cfg = x3d_m_config() if which == "m_head" else x3d_l_config()
    head = which != "l_backbone"
    shapes = _jax_param_shapes(which[0])
    if not head:
        shapes = {k: v for k, v in shapes.items() if k != "head"}
    got = sum(p.numel() for p in X3D(cfg, head=head).parameters())
    assert got == _count(shapes) == want


@pytest.mark.parametrize("t", [16, 13, 4], ids=["T16", "T13", "T4"])
def test_eval_logits_and_stage_features_match_jax(m_pair, t):
    """X3D-M on T-frame clips: a 16-frame clip takes T-tiles at stages 3
    and 4 (``plan_block``), which the plain se-sums follow."""
    jmodel, variables, model = m_pair
    x = _clip(t, seed=t)
    want, state = jax.jit(partial(jmodel.apply, train=False, classify=True,
                                  capture_intermediates=_stage_filter))(variables, jnp.asarray(x))
    inter = state["intermediates"]
    with torch.no_grad():
        h = torch.from_numpy(x)
        for i, name in enumerate(STAGE_NAMES):
            h = model.run_block(i, h)
            w = np.asarray(inter[name]["__call__"][0])
            assert h.shape == w.shape
            np.testing.assert_allclose(h.numpy(), w, rtol=0, atol=ATOL, err_msg=name)
        logits = model(torch.from_numpy(x), classify=True)
    assert logits.shape == (BATCH, 400) and logits.dtype == torch.float32
    assert float(np.abs(np.asarray(want)).max()) > 0.1  # not collapsed to 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_train_mode_logits_and_batch_statistics_match_jax():
    """One train-mode forward with dropout off on X3D-M's 16-frame clip:
    the logits, and the BN running statistics every layer (head included)
    moves to, each within 1e-4 of its largest value (fp32 sums in another
    order through 27 train-mode BNs; at 4 frames stage 4 normalises over 8 values a channel,
    which lifts that to 1.3e-4 absolute on the logits)."""
    jmodel = JaxX3D(dataclasses.replace(jax_x3d_m_config(), dropout_rate=0.0))
    variables = _seeded_tree(jmodel, seed=1)
    cfg = x3d_m_config(dropout_rate=0.0)
    model = X3D(cfg, head=True)
    model.load_state_dict(from_jax_variables(variables, cfg, head=True), strict=True)
    x = _clip(16, seed=5)
    want, updated = jax.jit(partial(jmodel.apply, train=True, classify=True,
                                    mutable=["batch_stats"]))(variables, jnp.asarray(x))
    model.train()
    with torch.no_grad():
        logits = model(torch.from_numpy(x), classify=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    stats = from_jax_variables(jax.tree_util.tree_map(np.asarray, dict(updated)), cfg, head=True)
    assert any(k.startswith("head.pre_bn.") for k in stats)
    state = model.state_dict()
    for k, v in stats.items():
        err = float((state[k] - v).abs().max())
        assert err <= 1e-4 * float(v.abs().max()), (k, err, float(v.abs().max()))


def test_dropout_draws_from_the_generator(m_pair):
    """Train mode at the default rate 0.5: one seed gives one mask, another
    seed another, and eval mode draws none."""
    _, _, model = m_pair
    x = torch.from_numpy(_clip(4, seed=2))
    with torch.no_grad():
        head_in = model(x)
        model.head.train()
        try:
            run = lambda seed: model.head(head_in, torch.Generator().manual_seed(seed))
            a, b, c = run(0), run(0), run(1)
        finally:
            model.head.eval()
        plain = model.head(head_in, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, plain)
    assert torch.equal(plain, model(x, classify=True))


def test_head_is_built_only_when_asked():
    tiny = dict(stem_dim_out=8, stage_dims=(8, 16, 24, 32), stage_inner_dims=(18, 36, 54, 72),
                stage_depths=(1, 1, 1, 1))
    plain_keys = set(X3D(X3DConfig(**tiny)).state_dict())
    head_keys = set(X3D(X3DConfig(**tiny), head=True).state_dict())
    assert not any(k.startswith("head.") for k in plain_keys)
    assert head_keys - plain_keys == {
        "head.pre_conv", "head.pre_bn.scale", "head.pre_bn.bias", "head.pre_bn.mean",
        "head.pre_bn.var", "head.post_conv", "head.proj_w", "head.proj_b"}
    with pytest.raises(ValueError, match="all 4 stages"):
        X3D(X3DConfig(**tiny), num_stages=3, head=True)
    with pytest.raises(ValueError, match="head=True"):
        X3D(X3DConfig(**tiny))(torch.zeros(1, 2, 16, 16, 3), classify=True)
    for task in ("bcd", "scd", "bda", "cc"):
        kw = dict(vocab_size=11, embed_dim=32, num_heads=4, num_layers=1) if task == "cc" else {}
        model = Change3D(Task(task), num_classes=1 if task in ("bcd", "cc") else 5,
                         in_height=32, in_width=32, backbone_cfg=X3DConfig(**tiny), device="cpu",
                         **kw)
        assert not any(".head." in k for k in model.state_dict()), task


def test_x3d_classifier_builds_on_the_device_asked_for():
    model = x3d_classifier(device="cpu", seed=3)
    assert not model.training and model.cfg == x3d_m_config() and model.head is not None
    assert next(model.parameters()).device.type == "cpu"
    again = x3d_classifier(device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  again.state_dict().values()))
    if not torch.cuda.is_available():  # the card is the default: no silent CPU fallback
        with pytest.raises(RuntimeError, match="device='cpu'"):
            x3d_classifier(seed=3)


@pytest.fixture(scope="module")
def pyth(tmp_path_factory):
    path = tmp_path_factory.mktemp("kinetics") / "X3D_TINY.pyth"
    torch.save({"model_state": make_random_x3d_state_dict(TINY_CFG, seed=4)}, str(path))
    return str(path)


def test_jax_tree_with_head_converts_strictly(pyth):
    """A JAX X3D tree with a head (JAX's converter on a Kinetics file)
    bridges into X3D(head=True) strictly, equal to the port's own converter
    on the file; without ``head`` the bridge drops it, as before."""
    jvars = jax.tree_util.tree_map(np.asarray, jax_load_x3d(pyth, TINY_CFG))
    assert "head" in jvars["params"]
    bridged = from_jax_variables(jvars, PCFG, head=True)
    direct = load_x3d_pretrained(pyth, PCFG)
    assert set(bridged) == set(direct)
    for k, v in direct.items():
        assert torch.equal(bridged[k], v), k
    X3D(PCFG, head=True).load_state_dict(bridged, strict=True)
    X3D(PCFG).load_state_dict(from_jax_variables(jvars, PCFG), strict=True)


def test_kinetics_file_classifies_as_the_torch_oracle(pyth):
    """``load_x3d_pretrained`` into X3D(head=True): the logits of the
    independent torch oracle (pytorchvideo's layout) on the same file."""
    model = X3D(PCFG, head=True)
    model.load_state_dict(load_x3d_pretrained(pyth, PCFG), strict=True)
    model.eval()
    x = _clip(5, seed=8)
    sd = torch.load(pyth, weights_only=False)["model_state"]
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        want = oracle_head(oracle_run_blocks(xt, sd, TINY_CFG)[-1], sd, TINY_CFG)
        got = model(torch.from_numpy(x), classify=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


def test_merge_backbone_loads_the_head_into_an_x3d_with_one(pyth):
    backbone = load_x3d_pretrained(pyth, PCFG)
    model = X3D(PCFG, head=True)
    merged = merge_backbone_variables(model.state_dict(), backbone, drop_head=False)
    assert set(merged) == set(backbone)
    assert all(torch.equal(merged[k], backbone[k]) for k in backbone)
    model.load_state_dict(merged, strict=True)
    own = X3D(PCFG, head=True, generator=torch.Generator().manual_seed(9)).state_dict()
    kept = merge_backbone_variables(own, backbone)  # drop_head: the model's own head
    assert set(kept) == set(own)
    for k, v in kept.items():
        assert torch.equal(v, own[k] if k.startswith("head.") else backbone[k]), k
    bare = X3D(PCFG)
    assert set(merge_backbone_variables(bare.state_dict(), backbone)) == set(
        bare.state_dict())
    with pytest.raises(ValueError, match="no Kinetics head"):
        merge_backbone_variables(bare.state_dict(), backbone, drop_head=False)
