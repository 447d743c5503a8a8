"""Full-scene tiling and the split serving forward of the port against the
JAX package, fp32 on the CPU with bridged TINY models: ``utils/tiling.py``
gives exactly JAX's windows, blend weights, tiles and untiled canvases;
``TiledPredictor`` gives JAX's blended soft maps within 1e-5 (BCD and SCD,
scenes smaller and larger than a tile, batches padded); ``predict_u8_async``
+ ``finalize_u8`` equals ``predict_u8`` bit for bit; ``Predictor.from_checkpoint``
reads a run's ``best/model.pt``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.inference import Predictor as JaxPredictor, TiledPredictor as JaxTiled
from change3d_tpu.models.trainer import Change3D as JaxChange3D, Task as JaxTask
from change3d_tpu.utils import tiling as jax_tiling
from change3d_tpu_torch.checkpoint.io import CheckpointManager
from change3d_tpu_torch.inference import Predictor, TiledPredictor, U8Launch
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.utils import tiling

from tests.test_torch_model import _cfgs, _load, _random_vars

TILE = 16
CLASSES = {"bcd": 1, "scd": 6, "bda": 5}


def bridged(task: str, seed: int = 0, h: int = TILE, w: int = TILE):
    """(JAX Predictor, port Predictor) over one seeded TINY model, fp32."""
    jcfg, cfg = _cfgs(True)
    jmodel = JaxChange3D(task=JaxTask(task), num_classes=CLASSES[task], in_height=h,
                         in_width=w, backbone_cfg=jcfg)
    z = jnp.zeros((1, h, w, 3), jnp.float32)
    variables = _random_vars(jmodel, z, z, seed=seed)
    model = _load(Change3D(Task(task), num_classes=CLASSES[task], in_height=h, in_width=w,
                           backbone_cfg=cfg, device="cpu"), variables, cfg)
    return (JaxPredictor(jmodel, variables, compute_dtype=jnp.float32),
            Predictor(model, compute_dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("full, size, stride", [(40, 16, 12), (16, 16, 4), (10, 16, 8),
                                                (97, 32, 32), (33, 8, 1)])
def test_window_starts_and_offsets_equal_jax(full, size, stride):
    assert tiling.window_starts(full, size, stride) == jax_tiling.window_starts(full, size, stride)
    for overlap in (0, 4, size - 1):
        assert (tiling.scene_offsets(full, full + 3, size, size, overlap)
                == jax_tiling.scene_offsets(full, full + 3, size, size, overlap))


@pytest.mark.parametrize("h, w, overlap", [(16, 16, 0), (16, 24, 4), (32, 32, 16), (8, 40, 3)])
def test_blend_window_equals_jax(h, w, overlap):
    np.testing.assert_array_equal(tiling.blend_window(h, w, overlap),
                                  jax_tiling.blend_window(h, w, overlap))


@pytest.mark.parametrize("h, w", [(40, 52), (10, 30), (16, 16)])
def test_tile_and_untile_equal_jax(h, w):
    scene = np.random.RandomState(h * w).randn(h, w, 3).astype(np.float32)
    tiles, offsets = tiling.tile_scene(scene, TILE, TILE, 4)
    want_tiles, want_offsets = jax_tiling.tile_scene(scene, TILE, TILE, 4)
    np.testing.assert_array_equal(tiles, want_tiles)
    assert offsets == want_offsets
    np.testing.assert_array_equal(np.asarray(tiling.pad_scene(scene, TILE, TILE)),
                                  jax_tiling.pad_scene(scene, TILE, TILE))
    maps = np.random.RandomState(1).rand(len(offsets), TILE, TILE, 2).astype(np.float32)
    np.testing.assert_array_equal(tiling.untile_scene(maps, offsets, h, w, 4),
                                  jax_tiling.untile_scene(maps, offsets, h, w, 4))


@pytest.mark.parametrize("task", ["bcd", "scd"])
@pytest.mark.parametrize("h, w, overlap, batch", [(40, 52, 4, 3), (12, 30, 6, 2), (16, 16, 0, 4)],
                         ids=["large", "small", "one_tile"])
def test_tiled_predictor_matches_jax(task, h, w, overlap, batch):
    jpred, pred = bridged(task, seed=3)
    rs = np.random.RandomState(h + w)
    pre, post = (rs.randn(h, w, 3).astype(np.float32) for _ in range(2))
    want = JaxTiled(jpred, overlap=overlap, batch_size=batch).predict_scene_probs(pre, post)
    tiled = TiledPredictor(pred, overlap=overlap, batch_size=batch)
    got = tiled.predict_scene_probs(pre, post)
    assert set(got) == set(want)
    for key, w_ in want.items():
        assert got[key].shape == w_.shape == (h, w, w_.shape[-1])
        err = np.abs(got[key] - w_).max()
        assert err <= 1e-5 * np.abs(w_).max(), (key, err)
    hard = tiled.predict_scene(pre, post)
    for key, val in Predictor.harden(got).items():
        np.testing.assert_array_equal(hard[key], val)


def test_tiled_predictor_refuses_an_overlap_of_a_whole_tile():
    _, pred = bridged("bcd")
    with pytest.raises(ValueError, match="overlap"):
        TiledPredictor(pred, overlap=TILE)


@pytest.mark.parametrize("task, width", [("bcd", 16), ("scd", 16), ("bda", 24)])
def test_async_launch_then_finalize_equals_predict_u8(task, width):
    _, pred = bridged(task, seed=4, w=width)
    rs = np.random.RandomState(9)
    pre, post = (rs.randint(0, 256, (3, 16, width, 3)).astype(np.uint8) for _ in range(2))
    launch = pred.predict_u8_async(pre, post)
    assert isinstance(launch, U8Launch) and launch.event is None  # the CPU is synchronous
    got = pred.finalize_u8(launch)
    want = pred.predict_u8(pre, post)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape[:3] == (3, 16, width)
        np.testing.assert_array_equal(got[key], want[key])
    # The same decisions as the float path.
    norm = lambda a: (a.astype(np.float32) / 255.0 - 0.5) / 0.5
    for key, val in pred.predict(norm(pre), norm(post)).items():
        np.testing.assert_array_equal(got[key], val)


def test_predictor_from_checkpoint_reads_best(tmp_path):
    _, pred = bridged("bcd", seed=5)
    CheckpointManager(str(tmp_path)).save_best(pred.model)
    _, other = bridged("bcd", seed=6)
    loaded = Predictor.from_checkpoint(other.model, str(tmp_path), compute_dtype=torch.float32,
                                       device="cpu")
    rs = np.random.RandomState(2)
    pre, post = (rs.randint(0, 256, (2, TILE, TILE, 3)).astype(np.uint8) for _ in range(2))
    for key, val in pred.predict_u8(pre, post).items():
        np.testing.assert_array_equal(loaded.predict_u8(pre, post)[key], val)
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(other.model, str(tmp_path / "none"), device="cpu")
