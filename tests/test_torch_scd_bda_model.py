"""The port's SCD and BDA Change3D and Predictor held against change3d_tpu
on the same weights (bridged by from_jax_variables, loaded strictly) and
the same inputs, in fp32 on the CPU: TINY backbone, 32², B = 2, tolerance
3e-3 relative / 3e-4 absolute (BCD's)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.inference import Predictor as JaxPredictor
from change3d_tpu.models.encoder import Encoder as JaxEncoder
from change3d_tpu.models.trainer import Change3D as JaxChange3D, Task as JaxTask
from change3d_tpu_torch.checkpoint.convert import from_jax_variables
from change3d_tpu_torch.inference import Predictor
from change3d_tpu_torch.models.encoder import Encoder
from change3d_tpu_torch.models.trainer import PERCEPTION_FRAMES, Change3D, Task
from change3d_tpu_torch.models.x3d import X3DConfig
from change3d_tpu_torch.ops import fused_block as fb

from tests.test_torch_model import ATOL, RTOL, TINY, _cfgs, _close, _load, _random_vars

HW, B = 32, 2
CLASSES = {Task.SCD: 6, Task.BDA: 5}
HEADS = {Task.SCD: {"pre": 6, "post": 6, "change": 1}, Task.BDA: {"cls": 5, "loc": 1}}


@functools.lru_cache(maxsize=None)
def _jax_model(task, seed):
    """The JAX model on the plain path and its seeded variables."""
    jcfg, _ = _cfgs(False)
    jmodel = JaxChange3D(task=JaxTask(task.value), num_classes=CLASSES[task], in_height=HW,
                         in_width=HW, backbone_cfg=jcfg)
    z = jnp.zeros((1, HW, HW, 3), jnp.float32)
    return jmodel, jax.device_get(_random_vars(jmodel, z, z, seed=seed))


@functools.lru_cache(maxsize=None)
def _jax_outputs(task):
    jmodel, variables = _jax_model(task, 0)
    pre, post = _images(3)
    fwd = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))
    return jax.device_get(fwd(variables, jnp.asarray(pre), jnp.asarray(post)))


def _pair(task, fused, seed=0):
    """(JAX model on the plain path, its seeded variables, the port's model
    with them loaded strictly)."""
    _, cfg = _cfgs(fused)
    jmodel, variables = _jax_model(task, seed)
    model = Change3D(task, num_classes=CLASSES[task], in_height=HW, in_width=HW,
                     backbone_cfg=cfg, device="cpu")
    return jmodel, variables, _load(model, variables, cfg)


def _images(seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(B, HW, HW, 3).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("task", [Task.SCD, Task.BDA], ids=["scd", "bda"])
def test_change3d_matches_jax(task, fused):
    _, _, model = _pair(task, fused)
    pre, post = _images(3)
    want = _jax_outputs(task)
    before = fb.fused_block_fwd.launches
    with torch.no_grad():
        got = model(torch.from_numpy(pre), torch.from_numpy(post))
    assert fb.fused_block_fwd.launches == before  # CPU tensors take the plain version
    assert set(got) == set(want)
    for key, n in HEADS[task].items():
        assert got[key].shape == (B, HW, HW, n), key
        _close(got[key], want[key], key)
    for key in ("change", "loc"):  # sigmoid heads
        if key in got:
            assert 0.0 < float(got[key].min()) and float(got[key].max()) < 1.0


@pytest.mark.parametrize("task", [Task.SCD, Task.BDA], ids=["scd", "bda"])
def test_bridged_state_dict_names_every_head(task):
    """The port's parameter names are JAX's: the bridge fills every entry of
    the port's state_dict and nothing else."""
    _, variables, model = _pair(task, True)
    names = set(from_jax_variables(variables, X3DConfig(**TINY)))
    assert names == set(model.state_dict())
    heads = {n.split(".")[0] for n in names if n.startswith("decoder")}
    assert heads == {f"decoder_{k}" for k in HEADS[task]}
    assert model.state_dict()["encoder.perception_frames"].shape == (
        1, PERCEPTION_FRAMES[task], HW, HW, 3)


@pytest.mark.parametrize("n_frames", [1, 2, 3], ids=["T3", "T4", "T5"])
def test_enhancement_lands_on_the_middle_frame(n_frames):
    """|pre - post| is added at temporal index T // 2: perception tap 0 at
    T = 3, tap 1 at T = 4 (BDA) and at T = 5 (SCD), as in JAX. After stage 3
    no block follows, so zeroing fc3 changes exactly that tap there."""
    cfg = X3DConfig(**TINY)
    enc = Encoder(n_frames, 16, 16, cfg, generator=torch.Generator().manual_seed(0)).eval()
    rs = np.random.RandomState(1)
    pre, post = (torch.from_numpy(rs.randn(1, 16, 16, 3).astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        a = enc(pre, post)[3]
        enc.fc3.conv.zero_()
        b = enc(pre, post)[3]
    changed = [i for i in range(n_frames) if not torch.equal(a[i], b[i])]
    assert changed == [(n_frames + 2) // 2 - 1] == [0 if n_frames == 1 else 1]


@pytest.mark.parametrize("task", [Task.SCD, Task.BDA], ids=["scd", "bda"])
def test_encoder_taps_match_jax(task):
    n = PERCEPTION_FRAMES[task]
    jcfg, cfg = _cfgs(False)
    pre, post = _images(4)
    jenc = JaxEncoder(num_perception_frames=n, in_height=HW, in_width=HW, cfg=jcfg)
    variables = _random_vars(jenc, jnp.asarray(pre), jnp.asarray(post), seed=2)
    want = jax.jit(jenc.apply)(variables, jnp.asarray(pre), jnp.asarray(post))
    enc = _load(Encoder(n, HW, HW, cfg, generator=torch.Generator().manual_seed(0)),
                variables, cfg)
    with torch.no_grad():
        got = enc(torch.from_numpy(pre), torch.from_numpy(post))
    assert [len(s) for s in got] == [n] * 4
    for i, (g, w) in enumerate(zip(got, want)):
        for j in range(n):
            _close(g[j], w[j], f"stage {i} tap {j}")


@pytest.mark.parametrize("task", [Task.SCD, Task.BDA], ids=["scd", "bda"])
def test_predictor_matches_jax_predictor(task):
    """The port's fused blocks (plain versions on the CPU) against the JAX
    package's plain path: probabilities, then the decisions away from a
    threshold or an argmax tie, for predict and predict_u8."""
    jmodel, variables, model = _pair(task, True, seed=1)
    rs = np.random.RandomState(5)
    pre_u8, post_u8 = (rs.randint(0, 256, (3, HW, HW, 3)).astype(np.uint8) for _ in range(2))
    pre, post = ((a.astype(np.float32) / 255.0 - 0.5) / 0.5 for a in (pre_u8, post_u8))
    jpred = JaxPredictor(jmodel, variables, compute_dtype=jnp.float32)
    pred = Predictor(model, compute_dtype=torch.float32, device="cpu")
    want_p, got_p = jpred.predict_probs(pre, post), pred.predict_probs(pre, post)
    assert set(got_p) == set(HEADS[task])
    for key, n in HEADS[task].items():
        assert got_p[key].shape == (3, HW, HW, n)
        np.testing.assert_allclose(got_p[key], want_p[key], rtol=RTOL, atol=ATOL, err_msg=key)
    if task == Task.SCD:  # class maps are softmax probabilities
        np.testing.assert_allclose(got_p["pre"].sum(-1), 1.0, rtol=1e-5)

    decided = {}
    for key, p in want_p.items():
        if p.shape[-1] == 1:
            decided[key] = np.abs(p[..., 0] - 0.5) > 1e-3
        else:
            top2 = np.sort(p, axis=-1)[..., -2:]
            decided[key] = top2[..., 1] - top2[..., 0] > 1e-3
    for got, want in ((pred.predict(pre, post), jpred.predict(pre, post)),
                      (pred.predict_u8(pre_u8, post_u8), jpred.predict_u8(pre_u8, post_u8))):
        assert set(got) == set(HEADS[task])
        for key, n in HEADS[task].items():
            assert got[key].shape == (3, HW, HW)
            assert got[key].dtype == (np.bool_ if n == 1 else want[key].dtype)
            assert decided[key].mean() > 0.9
            np.testing.assert_array_equal(got[key][decided[key]], want[key][decided[key]])
