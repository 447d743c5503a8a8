"""The port's HDF5 reader and writer (``change3d_tpu_torch/data/hdf5.py``)
against h5py, and its ``CaptionDataset`` against the JAX package's.

``torch_fixtures/levircc_tiny.hdf5`` was written by h5py 3.14 with its
defaults, as ``tools/prepare_cc_data.py`` writes (``f.attrs[
"captions_per_image"] = 5``, ``f.create_dataset("images", data=x)``), from
``fixture_images()``; the card's machine, which has no h5py, reads it too
(``chip_smoke.py``'s data phase)."""

import contextlib
import os
import pickle
import sys

import h5py
import numpy as np
import pytest

from change3d_tpu.data.datasets import CaptionDataset as JaxCaptionDataset
from change3d_tpu_torch.data import hdf5
from change3d_tpu_torch.data.datasets import CaptionDataset
from tests._tiny_cc import write_caption_dataset

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_fixtures", "levircc_tiny.hdf5")
FIXTURE_SEED, FIXTURE_SHAPE, FIXTURE_CPI = 20251017, (3, 2, 3, 16, 16), 5


def fixture_images() -> np.ndarray:
    return np.random.default_rng(FIXTURE_SEED).integers(0, 256, FIXTURE_SHAPE, dtype=np.uint8)


@contextlib.contextmanager
def h5py_blocked():
    """h5py cannot be imported inside the block."""
    saved = sys.modules["h5py"]
    sys.modules["h5py"] = None
    try:
        with pytest.raises(ImportError):
            import h5py as _  # noqa: F401
        yield
    finally:
        sys.modules["h5py"] = saved


def _images(n, hw, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 2, 3, hw, hw), dtype=np.uint8)


def _write_like_prepare_cc_data(path, images, cpi=5):
    """The writes of tools/prepare_cc_data.py: the attribute, an empty
    dataset, then one image at a time."""
    with h5py.File(path, "w") as f:
        f.attrs["captions_per_image"] = cpi
        dset = f.create_dataset("images", images.shape, dtype="uint8")
        for i, img in enumerate(images):
            dset[i] = img
        return dset.id.get_offset()


@pytest.mark.parametrize("n,hw", [(1, 256), (6, 256), (300, 8)])
def test_h5py_files_read_equal_without_h5py(tmp_path, n, hw):
    images = _images(n, hw, seed=n)
    path = str(tmp_path / "TRAIN_IMAGES_DS.hdf5")
    offset = _write_like_prepare_cc_data(path, images, cpi=7)
    with h5py_blocked():
        location, attrs = hdf5.read_file(path)
        assert location.offset == offset and location.shape == images.shape
        assert attrs == {"captions_per_image": 7}
        np.testing.assert_array_equal(location.map(), images)


def test_header_continued_in_a_continuation_block(tmp_path):
    """Many root attributes push the root's messages into continuation
    blocks; every attribute and the data still read equal."""
    images = _images(2, 16)
    path = str(tmp_path / "many.hdf5")
    with h5py.File(path, "w") as f:
        for i in range(150):
            f.attrs[f"attr_{i:03d}"] = np.int32(i * 3 - 100)
        f.attrs["scale"] = 0.25
        f.attrs["captions_per_image"] = 5
        offset = f.create_dataset("images", data=images).id.get_offset()
    with open(path, "rb") as f:  # the root header holds a continuation message
        assert b"\x10\x00" in f.read(200)[112:114]
    location, attrs = hdf5.read_file(path)
    assert location.offset == offset
    assert attrs["captions_per_image"] == 5 and attrs["scale"] == 0.25
    assert [attrs[f"attr_{i:03d}"] for i in range(150)] == [i * 3 - 100 for i in range(150)]
    np.testing.assert_array_equal(location.map(), images)


def test_committed_fixture_is_its_seed():
    with h5py_blocked():
        location, attrs = hdf5.read_file(FIXTURE)
        assert attrs == {"captions_per_image": FIXTURE_CPI}
        assert os.path.getsize(FIXTURE) < 10_000
        np.testing.assert_array_equal(location.map(), fixture_images())


def test_committed_fixture_reads_equal_in_h5py():
    with h5py.File(FIXTURE, "r") as f:
        assert int(f.attrs["captions_per_image"]) == FIXTURE_CPI
        np.testing.assert_array_equal(f["images"][...], fixture_images())


@pytest.mark.parametrize("n,hw", [(1, 256), (13, 32), (257, 4)])
def test_writer_files_read_equal_in_h5py(tmp_path, n, hw):
    images = _images(n, hw, seed=n + 1)
    path = str(tmp_path / "w.hdf5")
    hdf5.write_file(path, images, {"captions_per_image": 5})
    with h5py.File(path, "r") as f:
        assert dict(f.attrs) == {"captions_per_image": 5}
        assert f["images"].dtype == np.uint8 and f["images"].chunks is None
        np.testing.assert_array_equal(f["images"][...], images)
        offset = f["images"].id.get_offset()
    location, attrs = hdf5.read_file(path)
    assert location.offset == offset and attrs == {"captions_per_image": 5}
    np.testing.assert_array_equal(location.map(), images)


def test_writer_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="only uint8"):
        hdf5.write_file(str(tmp_path / "a"), np.zeros((1, 2), np.float32))
    with pytest.raises(ValueError, match="integer attributes"):
        hdf5.write_file(str(tmp_path / "a"), np.zeros((1, 2), np.uint8), {"x": 0.5})


def _refused_file(path, kind):
    images = _images(3, 8)
    libver = "latest" if kind == "latest" else "earliest"
    with h5py.File(path, "w", libver=libver) as f:
        f.attrs["captions_per_image"] = 5
        if kind == "chunked":
            f.create_dataset("images", data=images, chunks=(1, 2, 3, 8, 8))
        elif kind == "gzip":
            f.create_dataset("images", data=images, compression="gzip", shuffle=True)
        elif kind == "never written":
            f.create_dataset("images", images.shape, dtype="uint8")
        elif kind == "float":
            f.create_dataset("images", data=images.astype(np.float32))
        elif kind == "compound":
            f.create_dataset("images", data=np.zeros(3, [("a", "u1"), ("b", "f4")]))
        elif kind == "compact":
            space = h5py.h5s.create_simple(images.shape)
            plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            plist.set_layout(h5py.h5d.COMPACT)
            dset = h5py.h5d.create(f.id, b"images", h5py.h5t.STD_U8LE, space, plist)
            dset.write(h5py.h5s.ALL, h5py.h5s.ALL, images)
        else:
            f.create_dataset("images", data=images)


@pytest.mark.parametrize("kind,reason", [
    ("chunked", "chunked layout"),
    ("gzip", "filter pipeline"),
    ("latest", "superblock version [23]"),
    ("never written", "no storage allocated"),
    ("float", "float32; only uint8"),
    ("compound", "compound datatype"),
    ("compact", "compact layout"),
])
def test_refused_layouts_name_the_reason(tmp_path, kind, reason):
    path = str(tmp_path / "r.hdf5")
    _refused_file(path, kind)
    with pytest.raises(ValueError, match=reason):
        hdf5.read_file(path)


def test_refuses_a_file_that_is_not_hdf5(tmp_path):
    path = tmp_path / "x.hdf5"
    path.write_bytes(b"\0" * 4096)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.read_file(str(path))
    good = str(tmp_path / "g.hdf5")
    hdf5.write_file(good, _images(2, 8))
    with open(good, "r+b") as f:  # cut the data short
        f.truncate(os.path.getsize(good) - 10)
    with pytest.raises(ValueError, match="truncated"):
        hdf5.read_file(good)


@pytest.mark.parametrize("split", ["TRAIN", "TEST"])
def test_caption_dataset_items_equal_the_jax_package(tmp_path, split):
    root = str(tmp_path / "cc")
    write_caption_dataset(root, n_imgs=4, cpi=5, hw=16)
    ref = JaxCaptionDataset(root, "DS", split)
    with h5py_blocked():
        ds = CaptionDataset(root, "DS", split)
    assert len(ds) == len(ref) == 20 and ds.cpi == ref.cpi == 5
    for idx in range(len(ds)):
        got = ds.__getitem__(idx, np.random.default_rng(idx))
        want = ref.__getitem__(idx, np.random.default_rng(idx))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{split} {idx} {k}")
    ds.close()  # drops the map; the next item maps the file again
    assert ds._images is None
    np.testing.assert_array_equal(ds.__getitem__(0, np.random.default_rng(5))["pre"],
                                  ref.__getitem__(0, np.random.default_rng(5))["pre"])
    ref.close()


def test_caption_dataset_pickles_without_its_images(tmp_path):
    """A pickled dataset carries where the images lie, not their bytes,
    before and after an item was read; the copy reads equal items."""
    root = str(tmp_path / "cc")
    write_caption_dataset(root, n_imgs=6, cpi=5, hw=64)  # 295 KB of images
    with h5py_blocked():
        ds = CaptionDataset(root, "DS", "TEST")
    assert len(pickle.dumps(ds)) < 4096
    first = ds.__getitem__(7)
    assert isinstance(ds.images, np.memmap)
    blob = pickle.dumps(ds)
    assert len(blob) < 4096
    copy = pickle.loads(blob)
    assert copy._images is None
    for k, v in copy.__getitem__(7).items():
        np.testing.assert_array_equal(v, first[k])
