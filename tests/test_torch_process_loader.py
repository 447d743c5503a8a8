"""The port's worker-process loader (``data/process_pipeline.py``, the
``--loader grain`` of ``cli bcd/scd/bda/cc``) on the contracts of the JAX
package's grain loader (``tests/test_grain_pipeline.py``): deterministic
per (seed, epoch), a padded final batch with ``valid`` on every batch,
sharded padded evaluation row for row the threaded loader's, every sample
once; plus batches equal to the JAX package's threaded loader's (training
and evaluation, sharded or not, at 0 and 2 worker processes), resume
mid-epoch, LEVIR-CC HDF5 items through the workers, ``cli bcd --loader
grain`` on a TINY model, and no process outliving the one that started
the workers."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from change3d_tpu.data.datasets import BCDDataset as JaxBCDDataset
from change3d_tpu.data.pipeline import make_data_loader as jax_make_data_loader
from change3d_tpu.data.pipeline import pair_collate as jax_pair_collate
from change3d_tpu.data.transforms import TransformPipeline as JaxTransformPipeline
from change3d_tpu_torch import cli
from change3d_tpu_torch.data.datasets import BCDDataset, CaptionDataset
from change3d_tpu_torch.data.pipeline import (
    DataLoader,
    caption_collate,
    make_data_loader,
    pair_collate,
)
from change3d_tpu_torch.data.png import write_png
from change3d_tpu_torch.data.process_pipeline import ProcessDataLoader
from change3d_tpu_torch.data.transforms import TransformPipeline, make_transform_pipelines
from change3d_tpu_torch.train.caption_loop import _EveryFifth
from tests._tiny_cc import write_caption_dataset

HW = 16


@pytest.fixture(scope="module")
def bcd_root(tmp_path_factory):
    """5 train and 5 test pairs at 16², as the grain tests' layout."""
    root = str(tmp_path_factory.mktemp("levir"))
    rs = np.random.RandomState(0)
    for split in ("train", "test"):
        for d in ("t1", "t2", "label"):
            os.makedirs(os.path.join(root, split, d))
        for i in range(5):
            write_png(os.path.join(root, split, "t1", f"{i}.png"),
                      rs.randint(0, 255, (HW, HW, 3)).astype(np.uint8))
            write_png(os.path.join(root, split, "t2", f"{i}.png"),
                      rs.randint(0, 255, (HW, HW, 3)).astype(np.uint8))
            write_png(os.path.join(root, split, "label", f"{i}.png"),
                      (rs.randint(0, 2, (HW, HW)) * 255).astype(np.uint8))
    return root


def _data(root, split):
    train_tf, eval_tf = make_transform_pipelines("bcd", HW, HW)
    return BCDDataset(root, split, train_tf if split == "train" else eval_tf)


def _pres(loader):
    return [b["pre"].copy() for b in loader]


def test_shapes_and_determinism(bcd_root):
    loader = ProcessDataLoader(_data(bcd_root, "train"), 2, shuffle=True, seed=7, num_workers=0,
                               collate=pair_collate)
    assert len(loader) == 2
    a, b = _pres(loader), _pres(loader)
    assert len(a) == 2 and a[0].shape == (2, HW, HW, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)  # same epoch -> same batches
    loader.set_epoch(1)
    c = _pres(loader)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))
    other_seed = ProcessDataLoader(_data(bcd_root, "train"), 2, shuffle=True, seed=8,
                                   num_workers=0, collate=pair_collate)
    assert any(not np.array_equal(x, y) for x, y in zip(a, _pres(other_seed)))


def test_pad_final(bcd_root):
    loader = ProcessDataLoader(_data(bcd_root, "test"), 4, num_workers=0, collate=pair_collate,
                               pad_final=True)
    batches = list(loader)
    assert len(batches) == len(loader) == 2
    assert batches[1]["pre"].shape[0] == 4
    np.testing.assert_array_equal(batches[0]["valid"], [True] * 4)
    np.testing.assert_array_equal(batches[1]["valid"], [True, False, False, False])


def test_sharded_pad_final_matches_threaded(bcd_root):
    ds = _data(bcd_root, "test")
    globals_ = list(ProcessDataLoader(ds, 4, num_workers=0, collate=pair_collate, pad_final=True))
    shards = [list(ProcessDataLoader(ds, 4, num_workers=0, collate=pair_collate, pad_final=True,
                                     num_shards=2, shard_index=s)) for s in (0, 1)]
    assert len(shards[0]) == len(shards[1]) == len(globals_) == 2
    for b0, b1, g in zip(shards[0], shards[1], globals_):
        assert b0["pre"].shape[0] == b1["pre"].shape[0] == 2
        np.testing.assert_array_equal(np.concatenate([b0["pre"], b1["pre"]]), g["pre"])
        np.testing.assert_array_equal(np.concatenate([b0["valid"], b1["valid"]]), g["valid"])
    for s in (0, 1):
        threaded = list(DataLoader(ds, 4, num_workers=1, collate=pair_collate, pad_final=True,
                                   num_shards=2, shard_index=s))
        assert len(threaded) == len(shards[s])
        for pb, tb in zip(shards[s], threaded):
            for k in ("pre", "post", "label", "valid"):
                np.testing.assert_array_equal(pb[k], tb[k])


def test_covers_all_samples(bcd_root):
    ds = _data(bcd_root, "test")
    loader = ProcessDataLoader(ds, 2, num_workers=0, collate=pair_collate)
    assert sum(b["pre"].shape[0] for b in loader) == len(ds)
    seen = np.concatenate([b["label"] for b in loader])
    want = np.stack([ds[i][1] for i in range(len(ds))])
    np.testing.assert_array_equal(seen, want)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("split", ["train", "test"])
def test_batches_equal_jax_threaded_loader(bcd_root, split, workers):
    """Training (shuffled, augmented, ragged batch dropped) and padded
    evaluation, whole and as each of two shards, over two epochs: every
    batch equals the JAX package's threaded loader's on the same files."""
    train = split == "train"
    kw = dict(shuffle=train, seed=7, drop_last=train, pad_final=not train)
    ours_ds = BCDDataset(bcd_root, split, TransformPipeline(HW, HW, train=train))
    jax_ds = JaxBCDDataset(bcd_root, split, JaxTransformPipeline(HW, HW, train=train))
    for shard in ({}, dict(num_shards=2, shard_index=0), dict(num_shards=2, shard_index=1)):
        ours = ProcessDataLoader(ours_ds, 2, num_workers=workers, collate=pair_collate,
                                 **kw, **shard)
        theirs = jax_make_data_loader("threaded", jax_ds, 2, num_workers=1,
                                      collate=jax_pair_collate, **kw, **shard)
        try:
            for epoch in (0, 1):
                ours.set_epoch(epoch)
                theirs.set_epoch(epoch)
                got, want = list(ours), list(theirs)
                assert len(got) == len(want) == (2 if train else 3)
                for g, w in zip(got, want):
                    assert g.keys() == w.keys()
                    for k in w:
                        if k in ("pre", "post"):
                            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5)
                        else:
                            np.testing.assert_array_equal(g[k], w[k])
        finally:
            ours.close()


def test_batches_equal_at_zero_and_two_workers_and_resume(bcd_root):
    """Augmented, shuffled and sharded batches do not depend on the worker
    count; iter_from resumes with the epoch's own tail; the factory's
    'grain' kind is this loader."""
    ds = _data(bcd_root, "train")
    kw = dict(shuffle=True, seed=3, collate=pair_collate, drop_last=True)
    inproc = ProcessDataLoader(ds, 2, num_workers=0, **kw)
    workers = make_data_loader("grain", ds, 2, num_workers=2, **kw)
    assert isinstance(workers, ProcessDataLoader) and workers.num_workers == 2
    try:
        for epoch in (0, 1):
            inproc.set_epoch(epoch)
            workers.set_epoch(epoch)
            want = list(inproc)
            got = list(workers)
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
        tail = list(workers.iter_from(1))
        assert len(tail) == 1
        np.testing.assert_array_equal(tail[0]["pre"], want[1]["pre"])
        with pytest.raises(RuntimeError, match="ahead of the dataset"):
            list(workers.iter_from(2))
    finally:
        workers.close()
    with pytest.raises(ValueError, match="unknown loader kind"):
        make_data_loader("bogus", ds, 2)


def test_caption_hdf5_items_through_two_workers(tmp_path):
    """The LEVIR-CC dataset (HDF5 through data/hdf5.py) goes to the worker
    processes pickled without its images; sharded padded evaluation gives
    the threaded loader's rows."""
    root = str(tmp_path / "cc")
    write_caption_dataset(root, n_imgs=6, cpi=5, hw=HW)
    data = _EveryFifth(CaptionDataset(root, "DS", "TEST"))
    kw = dict(collate=caption_collate, pad_final=True, num_shards=2, shard_index=1)
    loader = ProcessDataLoader(data, 4, num_workers=2, **kw)
    try:
        got = list(loader)
    finally:
        loader.close()
    want = list(DataLoader(data, 4, num_workers=1, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_cli_bcd_takes_the_grain_loader(bcd_root, tmp_path, monkeypatch):
    """``cli bcd --device cpu --loader grain`` on the TINY model for two
    epochs (the workers decode, the loop trains, and validates from epoch
    1 on)."""
    import torch

    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3DConfig
    from change3d_tpu_torch.train import loop

    tiny = dict(stem_dim_out=8, stage_dims=(8, 16, 24, 32), stage_inner_dims=(18, 36, 54, 72),
                stage_depths=(1, 1, 1, 1))
    monkeypatch.setattr(loop, "build_model", lambda cfg: Change3D(
        Task.BCD, in_height=cfg.in_height, in_width=cfg.in_width,
        backbone_cfg=X3DConfig(**tiny), device=cfg.device,
        generator=torch.Generator().manual_seed(cfg.seed)))
    monkeypatch.delenv("CHANGE3D_PREEMPT_AFTER_STEP", raising=False)
    argv = ["bcd", "--file_root", bcd_root, "--save_dir", str(tmp_path / "exp"), "--device",
            "cpu", "--in_height", str(HW), "--in_width", str(HW), "--batch_size", "2",
            "--num_workers", "2", "--max_epochs", "2", "--compute_dtype", "float32",
            "--loader", "grain"]
    assert cli.build_parser().parse_args(argv).loader == "grain"
    res = cli.main(argv)
    assert set(res) >= {"last", "test_best"} and np.isfinite(res["last"]["F1"])
    run_dir = tmp_path / "exp" / "LEVIR-CD_iter_80000_lr_0.0002"
    assert (run_dir / "best" / "model.pt").exists()


_EXIT_SCRIPT = """
import json, multiprocessing.forkserver, multiprocessing.resource_tracker
import numpy as np
from change3d_tpu_torch.data.process_pipeline import ProcessDataLoader

class Rows:
    def __len__(self):
        return 12

    def __getitem__(self, i, rng=None):
        return {"pre": np.full((2,), i, np.float32)}

def stack(samples):
    return {"pre": np.stack([s["pre"] for s in samples])}

if __name__ == "__main__":
    loader = ProcessDataLoader(Rows(), 4, num_workers=2, collate=stack, seed=0)
    it = iter(loader)
    next(it)  # left suspended mid-epoch, workers up, at exit
    pids = [multiprocessing.forkserver._forkserver._forkserver_pid,
            multiprocessing.resource_tracker._resource_tracker._pid]
    pids += [w.pid for w in loader._loader._iterator._workers]
    print(json.dumps(pids), flush=True)
"""


def _running(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_no_process_outlives_its_parent(tmp_path):
    """A process that leaves a loader mid-epoch exits with its workers, the
    fork server and the resource tracker already ended, and without
    warnings of leaked semaphores."""
    script = tmp_path / "exit_with_workers.py"
    script.write_text(_EXIT_SCRIPT)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         env=env, timeout=120)
    left = [pid for pid in json.loads(out.stdout.splitlines()[-1]) if _running(pid)]
    assert out.returncode == 0, out.stderr
    assert len(json.loads(out.stdout.splitlines()[-1])) == 4 and not left, (left, out.stderr)
    assert "leaked" not in out.stderr and "Traceback" not in out.stderr, out.stderr
