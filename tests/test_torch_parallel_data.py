"""The port's process-sharded ``DataLoader`` gives, for every shard, the JAX
``DataLoader``'s local batches at the same ``num_shards`` / ``shard_index``
(one process, no group): sample ids and the augmented arrays drawn from the
global slot's rng, with shuffling and ``drop_last``, with ``pad_final`` and
its ``valid`` mask by global position, from ``iter_from`` on resume; the
shards put together are the single-process batch; and the same refusals."""

import numpy as np
import pytest

from change3d_tpu.data.pipeline import DataLoader as JaxDataLoader
from change3d_tpu_torch.data.pipeline import DataLoader
from change3d_tpu_torch.parallel import distributed
from change3d_tpu_torch.train import loop

from tests._torch_parallel import few_threads  # noqa: F401 (autouse)


class _Samples:
    """n samples: the id, and an 'augmentation' drawn from the rng."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx, rng=None):
        return {"id": np.int64(idx), "x": rng.standard_normal(3).astype(np.float32)}


def _collate(samples):
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _batches(loader, skip=0):
    return list(loader.iter_from(skip)) if skip else list(loader)


MODES = {
    "shuffle_drop_last": dict(n=21, batch=8, kw=dict(shuffle=True, seed=5)),
    "pad_final": dict(n=21, batch=8, kw=dict(shuffle=False, pad_final=True)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shards", [2, 4])
def test_shards_are_the_jax_loader_local_batches(mode, shards):
    m = MODES[mode]
    data = _Samples(m["n"])
    for epoch in (0, 1):
        for skip in (0, 1):
            whole = JaxDataLoader(data, m["batch"], num_workers=2, collate=_collate, **m["kw"])
            whole.set_epoch(epoch)
            want_whole = _batches(whole, skip)
            parts = []
            for index in range(shards):
                kw = dict(num_workers=2, collate=_collate, num_shards=shards, shard_index=index,
                          **m["kw"])
                ours, theirs = DataLoader(data, m["batch"], **kw), JaxDataLoader(
                    data, m["batch"], **kw)
                ours.set_epoch(epoch)
                theirs.set_epoch(epoch)
                got, want = _batches(ours, skip), _batches(theirs, skip)
                assert len(got) == len(want) == len(ours) - skip
                for g, w in zip(got, want):
                    assert g.keys() == w.keys()
                    for k in w:
                        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                parts.append(got)
            # The shards side by side are the one-process batches.
            for i, w in enumerate(want_whole):
                for k in w:
                    np.testing.assert_array_equal(
                        np.concatenate([p[i][k] for p in parts]), w[k], err_msg=k)


def test_padded_valid_is_by_global_position():
    data = _Samples(5)
    got = [list(DataLoader(data, 4, num_workers=1, collate=_collate, pad_final=True,
                           num_shards=2, shard_index=i)) for i in range(2)]
    assert [b["valid"].tolist() for b in got[0]] == [[True, True], [True, False]]
    assert [b["valid"].tolist() for b in got[1]] == [[True, True], [False, False]]
    assert got[1][1]["id"].tolist() == [4, 4]  # the last sample repeated as padding


def test_refusals_match_jax():
    data = _Samples(10)
    for kw, match in ((dict(num_shards=4), "must divide over 4 processes"),
                      (dict(num_shards=2, shuffle=False), "drop_last=True or pad_final=True")):
        for cls in (DataLoader, JaxDataLoader):
            with pytest.raises(ValueError, match=match):
                cls(data, 6, **kw)
    with pytest.raises(RuntimeError, match="ahead of the dataset"):
        next(iter(DataLoader(data, 4, shuffle=True, num_shards=2).iter_from(2)))


def test_global_batch_rounds_to_the_world_size(monkeypatch, capsys):
    monkeypatch.setattr(distributed, "world_size", lambda: 4)
    cfg = loop._check_config(loop.RunConfig(batch_size=6, device="cpu"))
    assert cfg.batch_size == 8
    assert "batch_size 6 rounded up to 8 (must divide over 4 processes)" in capsys.readouterr().out
    assert loop._check_config(loop.RunConfig(batch_size=8)).batch_size == 8
