"""The port's layer and norm ops against their change3d_tpu.ops
counterparts (fp32, CPU), and the port's isolation from JAX."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

import jax.numpy as jnp

from change3d_tpu.ops import layers as jl
from change3d_tpu.ops.norm import batch_norm_inference
from change3d_tpu_torch.ops import depthwise_conv
from change3d_tpu_torch.ops import layers as tl
from change3d_tpu_torch.ops.norm import BatchNorm

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("stride,padding,groups", [
    ((1, 1, 1), (0, 1, 1), 1), ((1, 2, 2), (1, 1, 1), 1), ((1, 1, 1), (2, 0, 0), 6),
])
def test_conv3d_matches_jax(stride, padding, groups):
    rs = np.random.RandomState(0)
    x = _rand(rs, 2, 5, 9, 8, 6)
    k = _rand(rs, 3, 3, 3, 6 // groups, 6, scale=0.2)  # DHWIO
    want = jl.conv3d(jnp.asarray(x), jnp.asarray(k), stride=stride, padding=padding,
                     groups=groups)
    got = tl.conv3d(_t(x), _t(k.transpose(4, 3, 0, 1, 2)), stride=stride, padding=padding,
                    groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# The main paths' two geometries (kernel, stride, padding): X3D's 5x1x1 stem
# conv at temporal stride 1 and 2, and the 3x3x3 bottleneck conv at stride 1
# and at block 0's (1, 2, 2).
DEPTHWISE = {
    "stem_st1": ((5, 1, 1), (1, 1, 1), (2, 0, 0)),
    "stem_st2": ((5, 1, 1), (2, 1, 1), (2, 0, 0)),
    "block_s1": ((3, 3, 3), (1, 1, 1), (1, 1, 1)),
    "block_s2": ((3, 3, 3), (1, 2, 2), (1, 1, 1)),
}


@pytest.mark.parametrize("geometry", list(DEPTHWISE))
@pytest.mark.parametrize("c", [24, 54, 216])
@pytest.mark.parametrize("t", [3, 4, 5, 16])
def test_depthwise_conv3d_matches_jax(t, c, geometry):
    """The op's plain version (the CPU kernel of ``c3d::depthwise_conv3d``)
    against the JAX op, on the clips of BCD/CC, BDA, SCD and X3D-M."""
    ks, stride, padding = DEPTHWISE[geometry]
    rs = np.random.RandomState(1)
    x, k = _rand(rs, 2, t, 7, 6, c), _rand(rs, *ks, 1, c, scale=0.3)
    want = jl.depthwise_conv3d(jnp.asarray(x), jnp.asarray(k), stride=stride, padding=padding)
    before = depthwise_conv.depthwise_conv3d.launches
    got = tl.depthwise_conv3d(_t(x), _t(k.transpose(4, 3, 0, 1, 2)), stride=stride,
                              padding=padding)
    assert depthwise_conv.depthwise_conv3d.launches == before
    assert got.is_contiguous() and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


class _OpLog(TorchDispatchMode):
    """The operators dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("needs", ["x", "kernel"])
def test_depthwise_conv3d_with_gradients_stays_on_conv3d(needs):
    """A call that needs a gradient takes F.conv3d (the kernel has no
    backward): no c3d op, no launch, the gradients of conv3d(groups=C); with
    gradients off the op runs, its CPU kernel the plain version, and never
    touches the kernel library."""
    rs = np.random.RandomState(2)
    x, k = _t(_rand(rs, 2, 3, 6, 5, 8)), _t(_rand(rs, 8, 1, 3, 3, 3, scale=0.3))
    (x if needs == "x" else k).requires_grad_(True)
    before = depthwise_conv.depthwise_conv3d.launches
    with _OpLog() as log:
        y = tl.depthwise_conv3d(x, k, stride=(1, 2, 2))
    assert torch.ops.c3d.depthwise_conv3d.default not in log.ops
    assert torch.ops.aten.convolution.default in log.ops
    g = torch.from_numpy(_rand(rs, *y.shape))
    got = torch.autograd.grad(y, x if needs == "x" else k, g)[0]
    x2, k2 = x.detach().clone().requires_grad_(needs == "x"), \
        k.detach().clone().requires_grad_(needs == "kernel")
    y2 = tl.conv3d(x2, k2, stride=(1, 2, 2), padding=(1, 1, 1), groups=8)
    want = torch.autograd.grad(y2, x2 if needs == "x" else k2, g)[0]
    assert torch.equal(y.detach(), y2.detach()) and torch.equal(got, want)

    def refuse(name):
        raise AssertionError(f"a CPU tensor loaded the {name} library")

    with torch.no_grad(), _OpLog() as log, pytest.MonkeyPatch.context() as mp:
        mp.setattr(depthwise_conv.cuda_build, "load", refuse)
        z = tl.depthwise_conv3d(x, k, stride=(1, 2, 2))
    assert log.ops[0] == torch.ops.c3d.depthwise_conv3d.default
    assert torch.equal(z, y.detach())
    assert depthwise_conv.depthwise_conv3d.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_depthwise_op_opcheck_and_flops(dtype):
    """``torch.library.opcheck`` on ``c3d::depthwise_conv3d`` (schema, fake
    kernel, AOT dispatch), and FlopCounterMode counts it as conv3d(groups=C)."""
    rs = np.random.RandomState(3)
    x, k = _t(_rand(rs, 2, 4, 6, 5, 8)).to(dtype), _t(_rand(rs, 8, 1, 3, 3, 3, scale=0.3))
    torch.library.opcheck(torch.ops.c3d.depthwise_conv3d.default, (x, k, [1, 2, 2], [1, 1, 1]))
    counts = []
    for fn in (lambda: tl.conv3d(x, k, stride=(1, 2, 2), padding=(1, 1, 1), groups=8),
               lambda: tl.depthwise_conv3d(x, k, stride=(1, 2, 2))):
        counter = FlopCounterMode(display=False)
        with torch.no_grad(), counter:
            fn()
        counts.append(counter.get_total_flops())
    assert counts[0] == counts[1] == 2 * 2 * 4 * 3 * 3 * 8 * 27


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_pointwise_conv3d_matches_jax(dtype):
    rs = np.random.RandomState(2)
    x, k = _rand(rs, 2, 3, 4, 4, 12), _rand(rs, 12, 20, scale=0.3)
    jx, tx = jnp.asarray(x), _t(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = jl.pointwise_conv3d(jx, jnp.asarray(k))
    got = tl.pointwise_conv3d(tx, _t(k))
    assert str(got.dtype).endswith(str(want.dtype))
    tol = TOL if dtype == np.float32 else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("ksize,padding", [(1, (0, 0)), (3, (1, 1))])
def test_conv2d_matches_jax(ksize, padding):
    rs = np.random.RandomState(3)
    x, k = _rand(rs, 2, 8, 8, 6), _rand(rs, ksize, ksize, 6, 4, scale=0.3)  # HWIO
    want = jl.conv2d(jnp.asarray(x), jnp.asarray(k), padding=padding)
    got = tl.conv2d(_t(x), _t(k.transpose(3, 2, 0, 1)), padding=padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv_transpose2d_matches_jax():
    rs = np.random.RandomState(4)
    x, k, b = _rand(rs, 2, 5, 6, 8), _rand(rs, 4, 4, 8, 8, scale=0.2), _rand(rs, 8)
    want = jl.conv_transpose2d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    # (kh, kw, I, O) -> torch's (I, O, kh, kw), not flipped
    got = tl.conv_transpose2d(_t(x), _t(k.transpose(2, 3, 0, 1)), _t(b))
    assert got.shape == (2, 10, 12, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_swish_and_squeeze_excite_match_jax():
    rs = np.random.RandomState(5)
    x = _rand(rs, 2, 3, 4, 4, 16)
    se = [_rand(rs, 16, 8, scale=0.3), _rand(rs, 8), _rand(rs, 8, 16, scale=0.3), _rand(rs, 16)]
    np.testing.assert_allclose(tl.swish(_t(x)).numpy(), np.asarray(jl.swish(jnp.asarray(x))),
                               **TOL)
    want = jl.squeeze_excite_3d(jnp.asarray(x), *map(jnp.asarray, se))
    got = tl.squeeze_excite_3d(_t(x), *map(_t, se))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_eval_matches_jax(dtype):
    rs = np.random.RandomState(6)
    x = _rand(rs, 2, 3, 4, 4, 10)
    scale, bias, mean = _rand(rs, 10) * 0.1 + 1, _rand(rs, 10) * 0.1, _rand(rs, 10) * 0.1
    var = (rs.rand(10) + 0.5).astype(np.float32)
    bn = BatchNorm(10).eval()
    bn.load_state_dict({"scale": _t(scale), "bias": _t(bias), "mean": _t(mean), "var": _t(var)})
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = batch_norm_inference(jx, *map(jnp.asarray, (scale, bias, mean, var)))
    got = bn(_t(x).to(dtype)).detach()
    assert got.dtype == dtype
    tol = TOL if dtype == torch.float32 else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)
    # Train mode normalises with the batch's statistics instead (held against
    # JAX in tests/test_torch_train_ops.py) and moves the running ones.
    assert torch.equal(bn.mean, _t(mean))
    bn.train()(_t(x))
    assert not torch.equal(bn.mean, _t(mean))


def test_eval_normalize_matches_jax_package():
    from change3d_tpu.data.transforms import eval_normalize as jax_pkg_normalize
    from change3d_tpu_torch.data.transforms import eval_normalize

    img = np.random.RandomState(7).randint(0, 256, (4, 5, 3)).astype(np.uint8)
    np.testing.assert_array_equal(eval_normalize(img), jax_pkg_normalize(img))


def test_import_leaves_jax_out():
    """Importing every module of the port (the HDF5 reader, the
    worker-process loader and METEOR included) pulls in no jax, flax,
    change3d_tpu, grain, h5py, cv2 or PIL module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import change3d_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'change3d_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "need = ['data.hdf5', 'data.process_pipeline', 'metrics.caption.meteor']\n"
        "missing = [n for n in need if 'change3d_tpu_torch.' + n not in sys.modules]\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'change3d_tpu', 'grain',\n"
        "                                    'h5py', 'cv2', 'PIL'))\n"
        "print(len([n for n in sys.modules if n.startswith('change3d_tpu_torch')]), bad,\n"
        "      missing)\n"
        "sys.exit(1 if bad or missing else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 15  # every module was imported


def test_sources_never_import_the_jax_package():
    pattern = re.compile(r"^\s*(import\s+(change3d_tpu|jax|flax|grain|h5py|cv2|PIL)\b(?!_torch)"
                         r"|from\s+(change3d_tpu|jax|flax|grain|h5py|cv2|PIL)\b(?!_torch))",
                         re.M)
    files = list((REPO / "change3d_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tools" / "profile_torch_bcd.py",
        REPO / "tools" / "phase_clocks.py"]
    assert len(files) >= 15
    hits = [f"{f}: {m.group(0).strip()}" for f in files for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def test_predictor_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the check is for CUDA-less hosts")
    from change3d_tpu_torch.inference import Predictor
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3DConfig

    tiny = X3DConfig(stem_dim_out=8, stage_dims=(8, 16, 24, 32),
                     stage_inner_dims=(18, 36, 54, 72), stage_depths=(1, 1, 1, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Change3D(Task.BCD, in_height=16, in_width=16, backbone_cfg=tiny)
    model = Change3D(Task.BCD, in_height=16, in_width=16, backbone_cfg=tiny, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(model)
