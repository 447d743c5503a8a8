"""Helpers of the port's multi-process tests (``tests/test_torch_parallel_*.py``):
a launcher of gloo processes on 127.0.0.1 and the functions they run.

The launched processes import this module by name (spawn), so it imports
nothing of JAX and no test module that does; the JAX references run in the
pytest process. Each launch has a deadline: a process still alive at it is
killed and the launch reports it as hung."""

from __future__ import annotations

import json
import multiprocessing
import os
import socket
import time

import numpy as np
import pytest
import torch

# tests/test_torch_model.TINY and tests/test_torch_cc_model.TINY_CC / DECODER_KW.
TINY = dict(stem_dim_out=8, stage_dims=(8, 16, 24, 32), stage_inner_dims=(18, 36, 54, 72),
            stage_depths=(2, 3, 3, 2))
TINY_CC = dict(TINY, stage_depths=(2, 3, 3, 3))
CC_KW = dict(vocab_size=11, embed_dim=32, num_heads=4, num_layers=2)
HW, LR, WD = 32, 1e-3, 1e-4
CLASSES = {"bcd": 1, "scd": 6, "bda": 5, "cc": 1}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads in the pytest process for the module: the
    spawned processes and the other test workers share the cores, and
    more threads only wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, args):
    torch.set_num_threads(1)
    fn(rank, world, port, *args)


def start_ranks(fn, world: int, *args):
    """Start ``fn(rank, world, port, *args)`` in ``world`` spawned
    processes; ``join_ranks`` waits for them."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, args)) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs, timeout: float = 60.0):
    """(exit codes by rank, whether any had to be killed at the deadline)."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    return [p.exitcode for p in procs], bool(hung)


def join_ok(procs, timeout: float = 60.0) -> None:
    codes, hung = join_ranks(procs, timeout)
    assert not hung and codes == [0] * len(procs), f"exit codes {codes}, hung {hung}"


def run_ranks(fn, world: int, *args, timeout: float = 60.0):
    return join_ranks(start_ranks(fn, world, *args), timeout)


def run_ok(fn, world: int, *args, timeout: float = 60.0) -> None:
    join_ok(start_ranks(fn, world, *args), timeout)


def init_gloo(rank, world, port, timeout=30.0) -> None:
    from change3d_tpu_torch.parallel import distributed

    distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu", timeout=timeout)


# -- one train step -----------------------------------------------------------


def make_model(task: str, dropout: float = 0.1, remat: bool = False, **cc_kw):
    """The seeded TINY model of ``task`` on the CPU (block pairs recomputed
    in the backward with ``remat``); ``cc_kw`` overrides CC_KW."""
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3DConfig

    gen = torch.Generator().manual_seed(3)
    if task == "cc":
        return Change3D(Task.CC, in_height=HW, in_width=HW,
                        backbone_cfg=X3DConfig(**TINY_CC, remat=remat), device="cpu",
                        generator=gen, dropout=dropout, **dict(CC_KW, **cc_kw))
    return Change3D(Task(task), num_classes=CLASSES[task], in_height=HW, in_width=HW,
                    backbone_cfg=X3DConfig(**TINY, remat=remat), device="cpu", generator=gen)


def global_batch(task: str, b: int = 4, seed: int = 6) -> dict:
    """A seeded global batch of ``task`` (numpy)."""
    rs = np.random.RandomState(seed)
    pre, post = (rs.randn(b, HW, HW, 3).astype(np.float32) for _ in range(2))
    if task == "bcd":
        label = (rs.rand(b, HW, HW, 1) > 0.7).astype(np.int32)
    elif task == "scd":
        label = np.stack([rs.randint(0, 6, (b, HW, HW)), rs.randint(0, 6, (b, HW, HW)),
                          (rs.rand(b, HW, HW) > 0.6).astype(int)], -1).astype(np.int32)
    elif task == "bda":
        label = np.stack([(rs.rand(b, HW, HW) > 0.5).astype(int),
                          rs.randint(0, 5, (b, HW, HW))], -1).astype(np.int32)
    else:
        caps = np.zeros((b, 12), np.int32)
        lengths = np.zeros(b, np.int32)
        for i in range(b):
            n = rs.randint(4, 12)
            caps[i, 0], caps[i, 1:n - 1], caps[i, n - 1] = 2, rs.randint(4, 11, n - 2), 3
            lengths[i] = n
        return {"pre": pre, "post": post, "caption": caps, "length": lengths}
    return {"pre": pre, "post": post, "label": label}


def one_step(task: str, state_path=None, remat: bool = False) -> dict:
    """One fp32 train step (constant lr, coupled decay) on this process's
    slice of ``global_batch(task)``: the loss, metrics, averaged gradients,
    and the parameters, buffers and Adam state after it."""
    from change3d_tpu_torch.parallel import distributed
    from change3d_tpu_torch.train.engine import train_step
    from change3d_tpu_torch.train.optim import torch_adam

    model = make_model(task, remat=remat)
    if state_path:
        model.load_state_dict(torch.load(state_path))
    opt = torch_adam(model.parameters(), weight_decay=WD)
    batch = global_batch(task)
    k = len(batch["pre"]) // distributed.world_size()
    lo = distributed.rank() * k
    local = {key: torch.from_numpy(v[lo:lo + k]) for key, v in batch.items()}
    gen = torch.Generator().manual_seed(11) if task == "cc" else None
    metrics = train_step(model, opt, lambda _: LR, local, 0, generator=gen)
    return {"metrics": {key: v.clone() for key, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "adam": opt.state_dict()["state"]}


def reference_worker(rank, world, port, tasks, out, state_paths=None) -> None:
    """The one-process reference: ``one_step`` of each task without a
    process group, saved to ``{out}/{task}-1-0.pt``. It runs spawned, as the
    ranks do (a fresh process at one intra-op thread): in the pytest process
    the step's fp32 rounding depends on what earlier test files left there,
    and a 6-worker run once put its BCD loss 1.0e-6 relative from the ranks'
    while a fresh process at any thread count agrees with them to 7.8e-8."""
    for task in tasks:
        torch.save(one_step(task, (state_paths or {}).get(task)),
                   os.path.join(out, f"{task}-1-0.pt"))


def step_worker(rank, world, port, tasks, out, state_paths=None, remats=(False,)) -> None:
    """``one_step`` of each task (from ``state_paths[task]`` where given)
    for each of ``remats``, saved to ``{out}/{task}-{world}-{rank}.pt``
    (``...-remat.pt`` with remat)."""
    init_gloo(rank, world, port)
    for task in tasks:
        for remat in remats:
            torch.save(one_step(task, (state_paths or {}).get(task), remat),
                       os.path.join(out, f"{task}-{world}-{rank}{'-remat' * remat}.pt"))


# -- the CLI -------------------------------------------------------------------


def tiny_build_model(cfg):
    """``train.loop.build_model`` at the TINY width."""
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3DConfig

    return Change3D(Task(cfg.task), num_classes=cfg.num_classes, in_height=cfg.in_height,
                    in_width=cfg.in_width, backbone_cfg=X3DConfig(**TINY), device=cfg.device,
                    generator=torch.Generator().manual_seed(cfg.seed))


def cli_worker(rank, world, port, runs, out) -> None:
    """``cli.main`` for each (name, argv, preempt-after-step on rank 1) of
    ``runs`` in turn, as process ``rank`` of ``world``, with the TINY model;
    each run's result goes to ``{out}/{name}-{rank}.json``."""
    from change3d_tpu_torch import cli
    from change3d_tpu_torch.train import loop

    loop.build_model = tiny_build_model
    dist_flags = ["--coordinator_address", f"127.0.0.1:{port}", "--num_processes", str(world),
                  "--process_id", str(rank)]
    for name, argv, preempt_on_rank1 in runs:
        os.environ.pop("CHANGE3D_PREEMPT_AFTER_STEP", None)
        if preempt_on_rank1 and rank == 1:
            os.environ["CHANGE3D_PREEMPT_AFTER_STEP"] = str(preempt_on_rank1)
        result = cli.main(list(argv) + dist_flags)
        with open(os.path.join(out, f"{name}-{rank}.json"), "w") as f:
            json.dump(result, f)


# -- CC evaluation -------------------------------------------------------------


def caption_eval(root: str, save_dir: str, eval_batch: int = 4, beam_size: int = 2) -> dict:
    """``evaluate_captions`` of a seeded TINY CC model (dropout off) over
    the TEST view of the dataset at ``root`` (``tests/_tiny_cc.py``), on
    this process's shard of every batch."""
    from change3d_tpu_torch.data.datasets import CaptionDataset
    from change3d_tpu_torch.data.pipeline import caption_collate, make_data_loader
    from change3d_tpu_torch.train.caption_loop import _EveryFifth, evaluate_captions

    with open(os.path.join(root, "WORDMAP_DS.json")) as f:
        word_map = json.load(f)
    data = _EveryFifth(CaptionDataset(root, "DS", "TEST"))
    loader = make_data_loader("threaded", data, eval_batch, shuffle=False, num_workers=1,
                              collate=caption_collate, pad_final=True)
    model = make_model("cc", dropout=0.0, vocab_size=len(word_map))
    return evaluate_captions(model, loader, word_map, beam_size, save_dir=save_dir)


def caption_eval_worker(rank, world, port, root, out) -> None:
    init_gloo(rank, world, port)
    scores = caption_eval(root, out)
    with open(os.path.join(out, f"scores-{rank}.json"), "w") as f:
        json.dump(scores, f)


# -- the collectives -----------------------------------------------------------


def collectives_worker(rank, world, port, out) -> None:
    """``initialize`` from the env vars (twice), then each collective; what
    this process saw goes to ``{out}/collectives-{rank}.json``."""
    from change3d_tpu_torch.data.pipeline import make_data_loader
    from change3d_tpu_torch.parallel import distributed

    os.environ.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES=str(world),
                      PROCESS_ID=str(rank))
    distributed.initialize(device="cpu", timeout=30.0)
    distributed.initialize("127.0.0.1:1", 99, 98, device="cpu")  # a second call does nothing
    seen = {"world": distributed.world_size(), "rank": distributed.rank(),
            "primary": distributed.is_primary()}
    x = torch.tensor([rank + 1.0, 10.0 * (rank + 1)], requires_grad=True)
    y = distributed.all_reduce_sum(x)
    (y * (rank + 1)).sum().backward()
    seen.update(forward=y.tolist(), backward=x.grad.tolist())
    a = np.arange((rank + 1) * (4 - rank % 3), dtype=np.int32).reshape(rank + 1, 4 - rank % 3)
    seen["gathered"] = [g.tolist() for g in distributed.allgather_padded(a + 100 * rank)]
    seen["any_one"] = distributed.any_process(rank == world - 1)
    seen["any_none"] = distributed.any_process(False)
    counts = [torch.tensor([[rank, 1], [2, 3]]), torch.tensor(rank + 0.5)]
    distributed.reduce_sum_(counts)
    seen["reduced"] = [c.tolist() for c in counts]
    loader = make_data_loader("threaded", list(range(8)), 4, drop_last=True)
    seen["loader_shard"] = [loader.num_shards, loader.shard_index, loader.local_batch_size]
    distributed.barrier()
    with open(os.path.join(out, f"collectives-{rank}.json"), "w") as f:
        json.dump(seen, f)


def lost_peer_worker(rank, world, port) -> None:
    """Process 1 fails right after start-up; process 0's next collective
    then times out and raises."""
    init_gloo(rank, world, port, timeout=3.0)
    if rank == 1:
        raise SystemExit(3)
    from change3d_tpu_torch.parallel import distributed

    distributed.all_reduce_sum(torch.ones(1))
