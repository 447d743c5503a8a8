"""The port's X3D / Encoder / ChangeDecoder / BCD Change3D / Predictor held
against change3d_tpu on the same weights (bridged by from_jax_variables)
and the same inputs, in fp32 on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from change3d_tpu.inference import Predictor as JaxPredictor
from change3d_tpu.models.change_decoder import ChangeDecoder as JaxChangeDecoder
from change3d_tpu.models.encoder import Encoder as JaxEncoder
from change3d_tpu.models.trainer import Change3D as JaxChange3D, Task as JaxTask
from change3d_tpu.models.x3d import X3D as JaxX3D, X3DConfig as JaxX3DConfig
from change3d_tpu_torch.checkpoint.convert import from_jax_variables
from change3d_tpu_torch.inference import Predictor
from change3d_tpu_torch.models.change_decoder import ChangeDecoder
from change3d_tpu_torch.models.encoder import Encoder
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import X3D, X3DConfig
from change3d_tpu_torch.ops import fused_block as fb

# The TINY backbone of tests/test_fused_model.py.
TINY = dict(stem_dim_out=8, stage_dims=(8, 16, 24, 32), stage_inner_dims=(18, 36, 54, 72),
            stage_depths=(2, 3, 3, 2))
RTOL, ATOL = 3e-3, 3e-4


def _cfgs(fused: bool, scan: bool = True):
    return (JaxX3DConfig(**TINY, fused_inference=fused, scan_blocks=scan),
            X3DConfig(**TINY, fused_inference=fused))


def _random_vars(module, *args, seed=0):
    """A variables tree of ``module`` (the JAX package's own layout, scan
    pairs included) filled with seeded numpy values: kernels scaled by
    1/sqrt(fan_in), BN statistics, scales and biases away from their trivial
    init so every fold and bias is exercised. Shapes come from
    ``jax.eval_shape``, which traces the init without running it."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "var":
            return (1.0 + 0.5 * rng.rand(*shape)).astype(np.float32)
        if name in ("bias", "mean", "b_reduce", "b_expand", "up_bias"):
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "perception_frames":
            return rng.randn(*shape).astype(np.float32)
        stacked = any(getattr(p, "key", None) == "pairs" for p in path)
        fan_in = int(np.prod(shape[1 if stacked else 0:-1]))
        return (rng.uniform(-1, 1, shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _load(module, variables, cfg):
    module.load_state_dict(from_jax_variables(variables, cfg), strict=True)
    return module.eval()


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=msg)


@pytest.mark.parametrize("fused", [False, True])
def test_x3d_matches_jax(fused):
    jcfg, cfg = _cfgs(fused)
    x = np.random.RandomState(0).randn(2, 3, 16, 16, 3).astype(np.float32)
    jmodel = JaxX3D(jcfg)
    variables = _random_vars(jmodel, jnp.asarray(x))
    want = jmodel.apply(variables, jnp.asarray(x))
    model = _load(X3D(cfg, generator=torch.Generator().manual_seed(0)), variables, cfg)
    before = fb.fused_block_fwd.launches
    with torch.no_grad():
        _close(model(torch.from_numpy(x)), want)
    assert fb.fused_block_fwd.launches == before  # CPU tensors take the plain version


def test_bridge_accepts_unrolled_and_scanned_trees():
    x = jnp.zeros((1, 3, 8, 8, 3), jnp.float32)
    scanned, _ = _cfgs(False, scan=True)
    unrolled, cfg = _cfgs(False, scan=False)
    # Same keys and values whichever layout the JAX tree used.
    from change3d_tpu.checkpoint.convert import pack_scanned_stages

    v_unrolled = _random_vars(JaxX3D(unrolled), x, seed=1)
    v_scan = {k: pack_scanned_stages(dict(v_unrolled[k]), scanned) for k in v_unrolled}
    assert "pairs" in v_scan["params"]["stage2"]
    a = from_jax_variables(jax.device_get(v_scan), cfg)
    b = from_jax_variables(v_unrolled, cfg)
    assert sorted(a) == sorted(b)
    assert "stage2.block2.bottleneck.se.w_reduce" in a and "stage2.block0.proj" in a
    assert set(X3D(cfg).state_dict()) == set(a)
    for k in b:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="depth"):
        from_jax_variables(v_unrolled, X3DConfig(**{**TINY, "stage_depths": (2, 5, 3, 2)}))


def test_encoder_matches_jax():
    jcfg, cfg = _cfgs(True)
    rs = np.random.RandomState(1)
    pre, post = (rs.randn(2, 16, 16, 3).astype(np.float32) for _ in range(2))
    jenc = JaxEncoder(num_perception_frames=1, in_height=16, in_width=16, cfg=jcfg)
    variables = _random_vars(jenc, jnp.asarray(pre), jnp.asarray(post))
    want = jenc.apply(variables, jnp.asarray(pre), jnp.asarray(post))
    enc = _load(Encoder(1, 16, 16, cfg, generator=torch.Generator().manual_seed(0)), variables, cfg)
    with torch.no_grad():
        got = enc(torch.from_numpy(pre), torch.from_numpy(post))
    assert len(got) == 4 and all(len(s) == 1 for s in got)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g[0], w[0], f"tap {i}")


def test_change_decoder_matches_jax():
    dims = (8, 8, 16, 24)
    rs = np.random.RandomState(2)
    feats = [rs.randn(2, 16 // 2 ** i, 16 // 2 ** i, d).astype(np.float32)
             for i, d in enumerate(dims)]
    jdec = JaxChangeDecoder(1, has_sigmoid=True, in_dims=dims)
    variables = _random_vars(jdec, [jnp.asarray(f) for f in feats])
    want = jdec.apply(variables, [jnp.asarray(f) for f in feats])
    dec = _load(ChangeDecoder(1, True, dims, generator=torch.Generator().manual_seed(0)),
                variables, X3DConfig(**TINY))
    with torch.no_grad():
        _close(dec([torch.from_numpy(f) for f in feats]), want)


def _bcd_pair(fused, seed=0, jax_fused=None):
    _, cfg = _cfgs(fused)
    jcfg, _ = _cfgs(fused if jax_fused is None else jax_fused)
    jmodel = JaxChange3D(task=JaxTask.BCD, in_height=16, in_width=16, backbone_cfg=jcfg)
    z = jnp.zeros((1, 16, 16, 3), jnp.float32)
    variables = _random_vars(jmodel, z, z, seed=seed)
    model = Change3D(Task.BCD, in_height=16, in_width=16, backbone_cfg=cfg, device="cpu")
    return jmodel, variables, _load(model, variables, cfg)


@pytest.mark.parametrize("fused", [False, True])
def test_change3d_bcd_matches_jax(fused):
    jmodel, variables, model = _bcd_pair(fused)
    rs = np.random.RandomState(3)
    pre, post = (rs.randn(2, 16, 16, 3).astype(np.float32) for _ in range(2))
    want = jmodel.apply(variables, jnp.asarray(pre), jnp.asarray(post), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(pre), torch.from_numpy(post))
    assert set(got) == {"change"} and got["change"].shape == (2, 16, 16, 1)
    _close(got["change"], want["change"])


def test_predictor_matches_jax_predictor():
    # The port's fused blocks against the JAX package's plain path.
    jmodel, variables, model = _bcd_pair(True, seed=1, jax_fused=False)
    rs = np.random.RandomState(4)
    pre_u8, post_u8 = (rs.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8) for _ in range(2))
    pre, post = ((a.astype(np.float32) / 255.0 - 0.5) / 0.5 for a in (pre_u8, post_u8))

    jpred = JaxPredictor(jmodel, variables, compute_dtype=jnp.float32)
    pred = Predictor(model, compute_dtype=torch.float32, device="cpu")
    want_p = jpred.predict_probs(pre, post)["change"]
    got_p = pred.predict_probs(pre, post)["change"]
    np.testing.assert_allclose(got_p, want_p, rtol=RTOL, atol=ATOL)

    decided = np.abs(want_p[..., 0] - 0.5) > 1e-3  # away from the threshold
    for got, want in ((pred.predict(pre, post), jpred.predict(pre, post)),
                      (pred.predict_u8(pre_u8, post_u8), jpred.predict_u8(pre_u8, post_u8))):
        assert got["change"].dtype == np.bool_ and got["change"].shape == (3, 16, 16)
        np.testing.assert_array_equal(got["change"][decided], want["change"][decided])


def test_postprocess_and_harden_match_jax_for_every_head_kind():
    from change3d_tpu.inference import postprocess_probs as jax_postprocess
    from change3d_tpu_torch.inference import postprocess_probs

    rs = np.random.RandomState(5)
    raw = {"change": rs.rand(2, 4, 8, 1).astype(np.float32),
           "cls": rs.randn(2, 4, 8, 5).astype(np.float32)}
    want = jax_postprocess({k: jnp.asarray(v) for k, v in raw.items()})
    got = postprocess_probs({k: torch.from_numpy(v) for k, v in raw.items()})
    for k in raw:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)
    hard, jhard = Predictor.harden(got), JaxPredictor.harden(want)
    for k in raw:
        np.testing.assert_array_equal(hard[k], jhard[k])


class _TwoHeads(torch.nn.Module):
    """A stand-in model with a binary and a class head, pixel-wise in its
    inputs, split as ``Change3D`` is: ``forward`` = ``heads(encoder(...))``."""

    def encoder(self, pre, post):
        return pre - post

    def heads(self, d):
        return {"change": torch.sigmoid(d[..., :1]), "cls": d}

    def forward(self, pre, post):
        return self.heads(self.encoder(pre, post))


@pytest.mark.parametrize("width", [16, 12], ids=["bitpacked", "unpacked"])
def test_predict_u8_decides_like_predict_for_every_head_kind(width):
    from change3d_tpu_torch.data.transforms import eval_normalize

    rs = np.random.RandomState(6)
    pre_u8, post_u8 = (rs.randint(0, 256, (2, 4, width, 3)).astype(np.uint8) for _ in range(2))
    pred = Predictor(_TwoHeads(), compute_dtype=torch.float32, device="cpu")
    got = pred.predict_u8(pre_u8, post_u8)
    want = pred.predict(eval_normalize(pre_u8), eval_normalize(post_u8))
    assert got["change"].dtype == np.bool_ and got["change"].shape == (2, 4, width)
    assert got["cls"].dtype == np.uint8
    np.testing.assert_array_equal(got["change"], want["change"])
    np.testing.assert_array_equal(got["cls"], want["cls"])


def test_seeded_init_follows_the_jax_distributions():
    """A seeded port model has every parameter of the JAX init, bridged onto
    the port's names and layouts, with the same shape and distribution: the
    same constant, or a std within 20% (so every fan-in agrees)."""
    jcfg, cfg = _cfgs(False)
    jmodel = JaxChange3D(task=JaxTask.BCD, in_height=16, in_width=16, backbone_cfg=jcfg)
    z = jnp.zeros((1, 16, 16, 3), jnp.float32)
    want = from_jax_variables(jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), z, z)),
                              cfg)
    got = Change3D(Task.BCD, in_height=16, in_width=16, backbone_cfg=cfg, device="cpu")
    got = got.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if float(w.std()) == 0:
            assert torch.equal(g, w), k
        elif w.numel() >= 256:
            assert 0.8 < float(g.std() / w.std()) < 1.25, k


def test_cc_builds_with_the_jax_cc_tree_keys():
    """Change3D(Task.CC) builds on the CPU with exactly the keys of the JAX
    CC tree bridged: stage 4, the caption decoder, no encoder.fc*."""
    kw = dict(vocab_size=7, embed_dim=TINY["stage_dims"][3], num_heads=4, num_layers=2)
    jmodel = JaxChange3D(task=JaxTask.CC, in_height=16, in_width=16,
                         backbone_cfg=_cfgs(False)[0], **kw)
    z = jnp.zeros((1, 16, 16, 3), jnp.float32)
    shapes = jax.eval_shape(lambda key: jmodel.init(key, z, z, captions=jnp.zeros((1, 4), jnp.int32)),
                            jax.random.PRNGKey(0))
    want = from_jax_variables(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                     shapes), X3DConfig(**TINY))
    model = Change3D(Task.CC, in_height=16, in_width=16, backbone_cfg=X3DConfig(**TINY),
                     device="cpu", **kw)
    assert set(model.state_dict()) == set(want)
    assert "encoder.x3d.stage4.block1.bottleneck.conv_a" in want
    assert not any(k.startswith("encoder.fc") for k in want)


def test_eval_only_batch_norm_refuses_training_mode():
    """BatchNorm is no longer eval-only: an eval forward leaves every running
    statistic alone, a train forward moves them and gives every parameter a
    gradient (the train-step parity is in tests/test_torch_train_step.py)."""
    model = Change3D(Task.BCD, in_height=16, in_width=16, backbone_cfg=X3DConfig(**TINY),
                     device="cpu")
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    before = {n: b.clone() for n, b in model.named_buffers()}
    with torch.no_grad():
        model.eval()(x, -x)
    assert all(torch.equal(b, before[n]) for n, b in model.named_buffers())
    model.train()(x, -x)["change"].sum().backward()
    assert all(not torch.equal(b, before[n]) for n, b in model.named_buffers())
    assert all(p.grad is not None for p in model.parameters())


def test_seeded_construction_is_deterministic():
    kw = dict(in_height=16, in_width=16, backbone_cfg=X3DConfig(**TINY), device="cpu")
    a, b = Change3D(Task.BCD, seed=7, **kw), Change3D(Task.BCD, seed=7, **kw)
    c = Change3D(Task.BCD, seed=8, **kw)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["encoder.perception_frames"], sc["encoder.perception_frames"])
    assert dataclasses.asdict(a.backbone_cfg)["fused_inference"] is True
