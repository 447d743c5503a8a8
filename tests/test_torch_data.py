"""The port's BCD data path held against change3d_tpu: PNG files against
cv2, the augmentation pipeline, the loader's batches and order, and the
confusion-matrix metrics."""

import os

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from change3d_tpu.data.datasets import BCDDataset as JaxBCDDataset
from change3d_tpu.data.pipeline import make_data_loader as jax_make_data_loader
from change3d_tpu.data.pipeline import pair_collate as jax_pair_collate
from change3d_tpu.data.transforms import TransformPipeline as JaxTransformPipeline
from change3d_tpu.metrics import confusion as jconf
from change3d_tpu_torch.data import png
from change3d_tpu_torch.data.datasets import BCDDataset
from change3d_tpu_torch.data.pipeline import make_data_loader, pair_collate
from change3d_tpu_torch.data.transforms import TransformPipeline
from change3d_tpu_torch.metrics import confusion


def _image(rs, shape, smooth):
    if not smooth:
        return rs.randint(0, 256, shape).astype(np.uint8)
    # Gradients make libpng pick the Sub/Up/Avg/Paeth row filters.
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    base = (3 * yy + 5 * xx + rs.randint(0, 3, shape[:2]))
    if len(shape) == 3:
        base = base[..., None] + np.arange(shape[2]) * 40
    return (base % 256).astype(np.uint8)


@pytest.mark.parametrize("shape", [(16, 16, 3), (37, 23, 3), (64, 48, 3), (16, 16), (31, 9)])
@pytest.mark.parametrize("smooth", [False, True], ids=["noise", "smooth"])
def test_png_round_trips_with_cv2(tmp_path, shape, smooth):
    img = _image(np.random.RandomState(sum(shape)), shape, smooth)
    cv_file, our_file = str(tmp_path / "cv.png"), str(tmp_path / "ours.png")
    cv2.imwrite(cv_file, img[..., ::-1] if img.ndim == 3 else img)  # cv2 writes BGR
    got = png.read_png(cv_file)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, img)
    png.write_png(our_file, img)
    back = cv2.imread(our_file, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., ::-1] if img.ndim == 3 else back, img)
    # The dataset readers: gray files are repeated to RGB as cv2 does.
    want_rgb = cv2.cvtColor(cv2.imread(cv_file, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(png.imread_rgb(cv_file), want_rgb)
    if img.ndim == 2:
        np.testing.assert_array_equal(png.imread_gray(cv_file), img)


def test_png_gray_reader_takes_rgb_files_of_gray_pixels(tmp_path):
    gray = _image(np.random.RandomState(1), (12, 10), True)
    path = str(tmp_path / "rgb.png")
    png.write_png(path, np.repeat(gray[..., None], 3, axis=2))
    np.testing.assert_array_equal(png.imread_gray(path), gray)
    np.testing.assert_array_equal(png.imread_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_png_refuses_what_it_does_not_read(tmp_path):
    """RGBA reads as cv2 reads it (alpha dropped, tests/test_torch_png_cv2.py
    covers every flavour); what is not a PNG still raises, and the writer
    takes uint8 only."""
    path = str(tmp_path / "rgba.png")
    cv2.imwrite(path, np.random.RandomState(0).randint(0, 256, (4, 4, 4)).astype(np.uint8))
    np.testing.assert_array_equal(png.read_png(path), cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
    with open(str(tmp_path / "not.png"), "wb") as f:
        f.write(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(tmp_path / "not.png"))
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(path, np.zeros((4, 4), np.float32))


@pytest.mark.parametrize("src_hw", [(32, 32), (48, 40), (24, 20)])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_transform_pipeline_matches_jax(src_hw, train):
    rs = np.random.RandomState(src_hw[0])
    image = rs.randint(0, 256, src_hw + (6,)).astype(np.uint8)
    label = (rs.rand(*src_hw) > 0.5).astype(np.uint8) * 255
    ours, theirs = TransformPipeline(32, 32, train=train), JaxTransformPipeline(32, 32, train=train)
    for seed in range(8):  # covers crop on and off, both flips and the exchange
        got = ours(image, label, np.random.default_rng(seed))
        want = theirs(image, label, np.random.default_rng(seed))
        assert got[0].dtype == np.float32 and got[1].dtype == np.int32
        assert got[0].shape == want[0].shape == (32, 32, 6) and got[1].shape == (32, 32, 1)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def bcd_root(tmp_path_factory):
    """10 train and 5 test pairs at 16², written by cv2 (as the JAX package
    writes them)."""
    root = str(tmp_path_factory.mktemp("bcd"))
    rs = np.random.RandomState(0)
    for split, n in (("train", 10), ("test", 5)):
        for d in ("t1", "t2", "label"):
            os.makedirs(os.path.join(root, split, d))
        for i in range(n):
            for d in ("t1", "t2"):
                cv2.imwrite(os.path.join(root, split, d, f"{i}.png"), _image(rs, (16, 16, 3), i % 2))
            cv2.imwrite(os.path.join(root, split, "label", f"{i}.png"),
                        (rs.rand(16, 16) > 0.5).astype(np.uint8) * 255)
    return root


def _loaders(root, split, train):
    kw = dict(shuffle=train, seed=7, num_workers=2, drop_last=train, pad_final=not train)
    ours = make_data_loader("threaded", BCDDataset(root, split, TransformPipeline(16, 16, train=train)),
                            4, collate=pair_collate, **kw)
    theirs = jax_make_data_loader("threaded",
                                  JaxBCDDataset(root, split, JaxTransformPipeline(16, 16, train=train)),
                                  4, collate=jax_pair_collate, **kw)
    return ours, theirs


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k == "pre" or k == "post":
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(g[k], w[k])


def test_train_loader_matches_jax_over_epochs_and_resume(bcd_root):
    ours, theirs = _loaders(bcd_root, "train", True)
    assert len(ours) == len(theirs) == 2
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        _assert_same_batches(list(ours), list(theirs))
        _assert_same_batches(list(ours.iter_from(1)), list(theirs.iter_from(1)))
    with pytest.raises(RuntimeError, match="ahead of the dataset"):
        list(ours.iter_from(2))


def test_eval_loader_pads_like_jax(bcd_root):
    ours, theirs = _loaders(bcd_root, "test", False)
    got, want = list(ours), list(theirs)
    _assert_same_batches(got, want)
    assert [b["valid"].sum() for b in got] == [4, 1]


def test_confusion_matrix_and_scores_match_jax():
    rs = np.random.RandomState(4)
    gt = rs.randint(-1, 3, (2, 9, 7))  # -1 and 2 lie outside a 2-class matrix
    pred = rs.randint(0, 3, (2, 9, 7))
    got = confusion.confusion_matrix(torch.from_numpy(gt), torch.from_numpy(pred), 2)
    want = np.asarray(jconf.confusion_matrix(jnp.asarray(gt), jnp.asarray(pred), 2))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    meter, jmeter = confusion.BinaryChangeMeter(), jconf.BinaryChangeMeter()
    for _ in range(2):
        meter.update(got)
        jmeter.update(want)
    assert meter.scores() == pytest.approx(jmeter.scores(), rel=1e-12)
    cm = np.array([[50.0, 3.0], [4.0, 7.0]])
    assert confusion.binary_change_scores(cm) == pytest.approx(jconf.binary_change_scores(cm))
