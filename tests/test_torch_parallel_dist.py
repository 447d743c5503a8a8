"""``change3d_tpu_torch.parallel``: process-group start-up and the
collectives, in 2 and 4 gloo processes on 127.0.0.1 (``tests/_torch_parallel.py``
launches them, each with a deadline).

- ``initialize`` from COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, its
  warm-up all-reduce, and a second call that changes nothing;
- ``all_reduce_sum``: the sum forward and the summed gradient backward;
- ``allgather_padded``: arrays of different shapes back whole, in process
  order; ``any_process``, ``reduce_sum_``, ``barrier``, and the loader
  factory sharding by process;
- alone (no group) every collective is the identity;
- a process that fails makes its peer's next collective raise (non-zero
  exits, nothing hangs);
- a process that leaves by an error tears its group down before the
  interpreter's teardown, and keeps its exit code."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from change3d_tpu_torch.data.pipeline import make_data_loader
from change3d_tpu_torch.parallel import distributed
from change3d_tpu_torch.parallel.mesh import multiple_of_devices

from tests import _torch_parallel as tp
from tests._torch_parallel import few_threads  # noqa: F401 (autouse)

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def seen(tmp_path_factory):
    dirs = {world: str(tmp_path_factory.mktemp(f"w{world}")) for world in WORLDS}
    procs = {world: tp.start_ranks(tp.collectives_worker, world, d) for world, d in dirs.items()}
    out = {}
    for world, d in dirs.items():
        tp.join_ok(procs[world], timeout=60)
        out[world] = []
        for r in range(world):
            with open(os.path.join(d, f"collectives-{r}.json")) as f:
                out[world].append(json.load(f))
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_initialize_from_env_once(seen, world):
    for r, s in enumerate(seen[world]):
        assert (s["world"], s["rank"], s["primary"]) == (world, r, r == 0)


@pytest.mark.parametrize("world", WORLDS)
def test_all_reduce_sum_forward_and_backward(seen, world):
    total = world * (world + 1) / 2
    for s in seen[world]:
        assert s["forward"] == [total, 10 * total]
        # Process q scales its output by q + 1: the backward sums those.
        assert s["backward"] == [total, total]


@pytest.mark.parametrize("world", WORLDS)
def test_allgather_padded_in_process_order(seen, world):
    want = [(np.arange((q + 1) * (4 - q % 3)).reshape(q + 1, 4 - q % 3) + 100 * q).tolist()
            for q in range(world)]
    for s in seen[world]:
        assert s["gathered"] == want


@pytest.mark.parametrize("world", WORLDS)
def test_flags_sums_and_sharded_loader(seen, world):
    for r, s in enumerate(seen[world]):
        assert s["any_one"] is True and s["any_none"] is False
        assert s["reduced"] == [[[world * (world - 1) // 2, world], [2 * world, 3 * world]],
                                world * (world - 1) / 2 + world / 2]
        assert s["loader_shard"] == [world, r, 4 // world]


@pytest.fixture
def alone(monkeypatch):
    """No start-up env vars; the module state reset afterwards."""
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    yield
    distributed.shutdown()


def test_alone_every_collective_is_the_identity(alone):
    distributed.initialize(device="cpu")  # no address, no count: single process
    assert not torch.distributed.is_initialized()
    assert (distributed.world_size(), distributed.rank(), distributed.is_primary()) == (1, 0, True)
    x = torch.ones(3, requires_grad=True)
    assert distributed.all_reduce_sum(x) is x
    a = np.arange(6).reshape(2, 3)
    (got,) = distributed.allgather_padded(a)
    assert got is a
    assert distributed.any_process(True) and not distributed.any_process(False)
    t = torch.tensor([1, 2])
    distributed.reduce_sum_([t])
    assert t.tolist() == [1, 2]
    distributed.barrier()
    assert make_data_loader("threaded", list(range(8)), 4, drop_last=True).num_shards == 1
    assert [multiple_of_devices(b, 4) for b in (1, 4, 5, 16)] == [4, 4, 8, 16]


def test_initialize_refuses_a_bad_process_id_and_a_missing_address(alone):
    with pytest.raises(ValueError, match="process_id 2 is not in"):
        distributed.initialize("127.0.0.1:1", 2, 2, device="cpu")
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.initialize(None, 2, 0, device="cpu")
    assert not torch.distributed.is_initialized()


def test_a_lost_process_fails_its_peer():
    codes, hung = tp.run_ranks(tp.lost_peer_worker, 2, timeout=60)
    assert not hung
    assert codes[1] == 3 and codes[0] not in (0, None)


EXIT_SCRIPT = """
import atexit
import torch.distributed as dist
from change3d_tpu_torch.parallel import distributed
atexit.register(lambda: print("group at exit:", dist.is_initialized(), flush=True))
distributed.initialize("127.0.0.1:%d", 1, 0, device="cpu", timeout=30.0)
print("group at start:", dist.is_initialized(), flush=True)
raise SystemExit(3)
"""


def test_the_group_is_torn_down_before_the_interpreter_exits():
    """``initialize`` registers ``shutdown`` at exit: a process leaving by
    an error (here SystemExit(3)) destroys its group before the
    interpreter's teardown, and keeps its own exit code."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", EXIT_SCRIPT % tp.free_port()], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 3, res.stderr[-2000:]
    assert res.stdout.split("\n")[:2] == ["group at start: True", "group at exit: False"], res.stdout
