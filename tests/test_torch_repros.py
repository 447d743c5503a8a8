"""The port's repro kernels (change3d_tpu_torch.ops.repros): their plain
PyTorch versions against the two Pallas repro kernels of
tests/manual_pallas_repros.py run in interpret mode on the CPU, the CPU
dispatch of their wrappers, the port's isolation from JAX, and the build's
source hash. The CUDA kernels are tested on the card by
tests/test_torch_cuda.py."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from change3d_tpu_torch.ops import cuda_build
from change3d_tpu_torch.ops import repros

REPO = Path(__file__).resolve().parent.parent


# The kernel bodies of tests/manual_pallas_repros.py:26-31 and :40-45.
def _dot_1d_kernel(x_ref, w_ref, o_ref):
    s = jnp.mean(x_ref[:], axis=0)
    o_ref[:] = (
        jnp.dot(s, w_ref[:], preferred_element_type=jnp.float32)[None]
        + jnp.zeros_like(x_ref[:], jnp.float32)
    ).astype(x_ref.dtype)


def _manual_dma_kernel(x_hbm, o_ref, scratch, sem):
    b = pl.program_id(0)
    cp = pltpu.make_async_copy(x_hbm.at[b], scratch, sem)
    cp.start()
    cp.wait()
    o_ref[0] = scratch[:] * 2.0


def _pallas_dot_1d(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    out = pl.pallas_call(_dot_1d_kernel, out_shape=jax.ShapeDtypeStruct(xj.shape, jnp.bfloat16),
                         interpret=True)(xj, wj)
    return np.asarray(out.astype(jnp.float32))


def _pallas_manual_dma(x: np.ndarray) -> np.ndarray:
    n, r, c = x.shape
    out = pl.pallas_call(
        _manual_dma_kernel,
        grid=(n,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, r, c), lambda b: (b, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, r, c), jnp.float32),
        scratch_shapes=[pltpu.VMEM((r, c), jnp.float32), pltpu.SemaphoreType.DMA(())],
        interpret=True,
    )(jnp.asarray(x))
    return np.asarray(out)


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16, back in fp32 (both sides get the same inputs)."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("seed,shape", [(0, (256, 128, 128)), (1, (64, 40, 40))],
                         ids=["repro_shape", "small"])
def test_dot_1d_plain_version_matches_pallas(seed, shape):
    r, c, n = shape  # the Pallas body broadcasts onto x's shape: n == c
    rs = np.random.RandomState(seed)
    x, w = _bf16(rs.randn(r, c)), _bf16(rs.randn(c, n))
    want = _pallas_dot_1d(x, w)
    got = repros.dot_1d(torch.from_numpy(x).to(torch.bfloat16),
                        torch.from_numpy(w).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (r, n)
    # one bf16 ulp of max(|ref|, 1): fp32 sums run in another order on each side
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1.0))) - 7)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()


@pytest.mark.parametrize("seed,shape", [(0, (4, 128, 128)), (1, (3, 16, 8))],
                         ids=["repro_shape", "small"])
def test_manual_dma_plain_version_matches_pallas_exactly(seed, shape):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    want = _pallas_manual_dma(x)
    got = repros.manual_dma(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_on_cpu_take_plain_versions_without_counting():
    x, w, xd = repros.repro_operands(2, "cpu")
    before = (repros.dot_1d.launches, repros.manual_dma.launches)
    assert torch.equal(repros.dot_1d(x, w), repros.dot_1d_reference(x, w))
    assert torch.equal(repros.manual_dma(xd), repros.manual_dma_reference(xd))
    assert (repros.dot_1d.launches, repros.manual_dma.launches) == before


def test_repro_operands_have_the_repros_shapes():
    x, w, xd = repros.repro_operands(0, "cpu")
    assert (x.shape, x.dtype) == ((256, 128), torch.bfloat16)
    assert (w.shape, w.dtype) == ((128, 128), torch.bfloat16)
    assert (xd.shape, xd.dtype) == ((4, 128, 128), torch.float32)
    assert torch.equal(repros.repro_operands(0, "cpu")[2], xd)


def test_bf16_ulps_used_reads_the_two_ulp_limit():
    ref = torch.tensor([0.5, 3.0, -100.0])
    exact = repros.bf16_ulps_used(ref, ref)
    one_ulp_at_3 = repros.bf16_ulps_used(ref + torch.tensor([0.0, 2.0 ** -6, 0.0]), ref)
    assert exact == 0.0 and one_ulp_at_3 == pytest.approx(0.5)


def test_entry_point_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this checks the CUDA-less path")
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        repros.main()


def test_repros_module_leaves_jax_out():
    """ops/repros.py imports no jax, flax or change3d_tpu module, directly
    or through what it imports."""
    code = (
        "import sys\n"
        "import change3d_tpu_torch.ops.repros\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'change3d_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_library_path_follows_every_header(tmp_path, monkeypatch):
    """An edit to a csrc/*.cuh header gives every CUDA library a new path,
    so a stale build is never reused; the host library (meteor.cpp, which
    includes no .cuh) follows its own source only."""
    for f in cuda_build.CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    before = {name: cuda_build.library_path(name) for name in cuda_build.SIGNATURES}
    assert set(before) == {"fused_block", "depthwise_conv3d", "repros", "meteor"}
    header = tmp_path / "ptx.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: cuda_build.library_path(name) for name in cuda_build.SIGNATURES}
    cuda = {"fused_block", "depthwise_conv3d", "repros"}
    assert all(after[n] != before[n] for n in cuda) and after["meteor"] == before["meteor"]
    assert all(p.parent == cuda_build.BUILD_DIR for p in after.values())
    source = tmp_path / "meteor.cpp"
    source.write_text(source.read_text() + "\n// edited\n")
    assert cuda_build.library_path("meteor") != after["meteor"]
