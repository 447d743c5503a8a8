"""The port's SCD and BDA data path held against change3d_tpu: the
augmentation pipelines under the same generator (images 1e-5, labels
exact; cv2 on the JAX side only), and the datasets and loaders on tiny
on-disk SECOND and xBD layouts written by cv2, BDA's BGR order and its
'disaster' -> 'disaster_target' label names included."""

import os

import cv2
import numpy as np
import pytest

from change3d_tpu.data.datasets import BDADataset as JaxBDADataset
from change3d_tpu.data.datasets import SCDDataset as JaxSCDDataset
from change3d_tpu.data.pipeline import make_data_loader as jax_make_data_loader
from change3d_tpu.data.pipeline import pair_collate as jax_pair_collate
from change3d_tpu.data.transforms import TransformPipeline as JaxTransformPipeline
from change3d_tpu_torch.data.datasets import DATASETS, BDADataset, SCDDataset
from change3d_tpu_torch.data.pipeline import make_data_loader, pair_collate
from change3d_tpu_torch.data.transforms import TransformPipeline

from tests.test_torch_data import _assert_same_batches


def _label(rs, task, hw):
    if task == "scd":
        return np.stack([rs.randint(0, 6, hw), rs.randint(0, 6, hw),
                         (rs.rand(*hw) > 0.5).astype(int)], -1).astype(np.uint8)
    return np.stack([(rs.rand(*hw) > 0.5).astype(int), rs.randint(0, 5, hw)], -1).astype(np.uint8)


@pytest.mark.parametrize("src_hw", [(32, 32), (48, 40), (24, 20)])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("task", ["scd", "bda"])
def test_transform_pipeline_matches_jax(task, src_hw, train):
    rs = np.random.RandomState(src_hw[0])
    image = rs.randint(0, 256, src_hw + (6,)).astype(np.uint8)
    label = _label(rs, task, src_hw)
    ours = TransformPipeline(32, 32, task, train=train)
    theirs = JaxTransformPipeline(32, 32, task, train=train)
    channels = label.shape[-1]
    for seed in range(8):  # covers crop on and off, both flips and the exchange
        got = ours(image, label, np.random.default_rng(seed))
        want = theirs(image, label, np.random.default_rng(seed))
        assert got[0].dtype == np.float32 and got[1].dtype == np.int32
        assert got[0].shape == want[0].shape == (32, 32, 6)
        assert got[1].shape == want[1].shape == (32, 32, channels)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[1], want[1])
    # No binarisation: the class ids come through (BCD alone takes ceil(label / 255)).
    assert got[1].max() > 1


def test_scd_exchange_swaps_label1_and_label2_and_keeps_change():
    rs = np.random.RandomState(0)
    image = rs.randint(0, 256, (16, 16, 6)).astype(np.uint8)
    label = _label(rs, "scd", (16, 16))
    pipe = TransformPipeline(16, 16, "scd", train=True)
    exchanged = 0
    for seed in range(16):
        img, lab = pipe(image, label, np.random.default_rng(seed))
        draws = np.random.default_rng(seed).random(4)  # crop, vflip, hflip, exchange
        if draws[0] < 0.5:
            continue  # the crop draws two integers: the exchange draw moves on
        if draws[3] < 0.5:
            exchanged += 1
            want = label[..., [1, 0, 2]]
        else:
            want = label
        want = want[::-1] if draws[1] < 0.5 else want
        want = want[:, ::-1] if draws[2] < 0.5 else want
        np.testing.assert_array_equal(lab, want)
    assert exchanged > 0


def test_pipeline_refuses_an_unknown_task():
    with pytest.raises(ValueError, match="task"):
        TransformPipeline(16, 16, "cc")


def _write_layout(root, task, rs, n_train=6, n_test=3, hw=16):
    """A tiny SECOND or xBD layout written by cv2 (as the JAX package
    writes); xBD label files carry the 'disaster_target' name."""
    dirs = {"scd": ("t1", "t2", "label1", "label2", "change"),
            "bda": ("t1", "t2", "label1", "label2")}[task]
    for split, n in (("train", n_train), ("test", n_test)):
        for d in dirs:
            os.makedirs(os.path.join(root, split, d))
        for i in range(n):
            name = f"{i:02d}.png" if task == "scd" else f"guatemala-volcano_{i:02d}_pre_disaster.png"
            label_name = name.replace("disaster", "disaster_target")
            for d in ("t1", "t2"):
                # Channels that differ, so a BGR/RGB mix-up shows.
                img = rs.randint(0, 256, (hw, hw, 3)).astype(np.uint8)
                img[..., 0] //= 4
                cv2.imwrite(os.path.join(root, split, d, name), img)
            label = _label(rs, task, (hw, hw))
            for c, d in enumerate(dirs[2:]):
                cv2.imwrite(os.path.join(root, split, d, label_name), label[..., c])


@pytest.fixture(scope="module", params=["scd", "bda"])
def layout(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(request.param))
    _write_layout(root, request.param, np.random.RandomState(1))
    return request.param, root


def test_dataset_items_match_jax(layout):
    task, root = layout
    ours = {"scd": SCDDataset, "bda": BDADataset}[task](root, "train")
    theirs = {"scd": JaxSCDDataset, "bda": JaxBDADataset}[task](root, "train")
    assert DATASETS[task] is type(ours) and len(ours) == len(theirs) == 6
    for i in range(len(ours)):
        (img, lab), (jimg, jlab) = ours[i], theirs[i]
        assert img.dtype == jimg.dtype == np.uint8 and img.shape == (16, 16, 6)
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(lab, jlab)
        assert lab.shape == (16, 16, 3 if task == "scd" else 2)
    if task == "bda":  # BGR: the first channel is the one written quartered
        raw = cv2.imread(ours.pre_images[0], cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(ours[0][0][..., :3], raw)
        assert all("disaster_target" in p for p in ours.label_paths[0])


def test_dataset_refuses_a_missing_label_file(layout, tmp_path):
    task, root = layout
    label = os.path.join(root, "test", "label2", sorted(os.listdir(
        os.path.join(root, "test", "label2")))[0])
    moved = str(tmp_path / "moved.png")
    os.rename(label, moved)
    try:
        with pytest.raises(FileNotFoundError):
            DATASETS[task](root, "test")
    finally:
        os.rename(moved, label)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_loader_batches_match_jax(layout, train):
    task, root = layout
    split = "train" if train else "test"
    kw = dict(shuffle=train, seed=7, num_workers=2, drop_last=train, pad_final=not train)
    ours = make_data_loader("threaded", DATASETS[task](root, split, TransformPipeline(
        16, 16, task, train=train)), 2, collate=pair_collate, **kw)
    jds = {"scd": JaxSCDDataset, "bda": JaxBDADataset}[task]
    theirs = jax_make_data_loader("threaded", jds(root, split, JaxTransformPipeline(
        16, 16, task, train=train)), 2, collate=jax_pair_collate, **kw)
    for epoch in (0, 1) if train else (0,):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = list(ours)
        _assert_same_batches(got, list(theirs))
        assert got[0]["label"].shape == (2, 16, 16, 3 if task == "scd" else 2)
