"""Open-loop serving: the port's HTTP server (``serving.make_server`` over
``PredictService`` with a ``Predictor``, bf16, as ``cli serve`` builds it:
``batch_size`` 16, buckets 4/8/16, ``max_delay_ms`` 10, every bucket warmed
up) on 127.0.0.1 at a port the system picks, and a load generator in a
child process (``benchlib/loadgen.py``) that sends one 256x256 pair per
request on the raw wire at Poisson arrivals of a fixed rate (traffic keys:
``rate_per_s``, ``pool``, ``senders``, ``kept``, ``batch``,
``max_delay_ms``). The senders are a fixed pool, each waiting for its
answer: where the rate exceeds what the server answers, they fall behind
the schedule and the load becomes ``senders`` concurrent clients. Reports
``served_per_s``: requests answered over the time from the first arrival
to the last answer. Each request is timed from when it was due; the
median and the 95th percentile over every request go to standard error.
The batcher's counters are read before and after the window.

The check compares the masks of ``kept`` requests drawn from the seed, as
they came back over the wire, with the fp32 reference's decisions for
their pairs, and counts requests that failed or never came back.

Variant (the control, never run by the benchmark itself): ``fp8`` the
reference with float8 products behind the server."""

from __future__ import annotations

import math
import multiprocessing
import sys
import threading
import time
from multiprocessing import resource_tracker

import numpy as np
import torch

from benchmark.benchlib import compare, inputs, loadgen, program
from benchmark.benchlib.controls import Fp8Predictor
from benchmark.benchlib.runner import Check, Window
from benchmark.reference.change3d import make_params


class Driver:
    def __init__(self, cell, seed: int, device: str, variant=None, rate=None):
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.limits, self.device, self.seed = cfg, cell.limits, device, seed
        self.rate = rate or tr["rate_per_s"]
        self.pool = tr["pool"]
        self.params = make_params(cfg, seed, device)
        from change3d_tpu_torch.inference import Predictor
        from change3d_tpu_torch.serving import PredictService, make_server

        if variant == "fp8":
            predictor = Fp8Predictor(cfg, self.params, device)
        else:
            model = program.build_model(cfg, self.params, device)
            predictor = Predictor(model, compute_dtype=getattr(torch, cfg["inference_dtype"]),
                                  device=device)
        self.service = PredictService(cfg["task"], predictor, batch_size=tr["batch"],
                                      max_delay_ms=tr["max_delay_ms"], warmup=True)
        self.server = make_server(self.service, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self._tr = tr
        self.child = self.pipe = None
        self.result = None

    def _start_child(self, seconds: float) -> None:
        ctx = multiprocessing.get_context("spawn")
        self.pipe, child_end = ctx.Pipe()
        self.child = ctx.Process(target=loadgen.run, args=(
            child_end, self.server.server_address[1], self.seed, self.pool,
            self.cfg["image_size"], self.rate, seconds, self._tr["senders"], self._tr["kept"]),
            daemon=True)
        self.child.start()
        child_end.close()
        if not self.pipe.poll(120) or self.pipe.recv() != "ready":
            raise RuntimeError("the load generator did not come up")

    def window(self, seconds: float, tracer) -> Window:
        sync = torch.cuda.synchronize if self.device == "cuda" else None
        self._start_child(seconds)
        stats = self.service.stats
        before = (stats.batches_total, stats.batched_requests_total)
        self.pipe.send("go")
        t0 = time.perf_counter()
        while not self.pipe.poll(0.05):
            tracer.tick(time.perf_counter(), t0, 0, sync)
            if not self.child.is_alive() and not self.pipe.poll(0):
                raise RuntimeError("the load generator died")
        self.result = res = self.pipe.recv()
        self.child.join(30)
        batches = stats.batches_total - before[0]
        requests = stats.batched_requests_total - before[1]
        lat = res["latency"]
        done = np.sort(lat[~np.isnan(lat)])
        failed = len(lat) - len(done)
        # Nearest rank over every request; one that never came back ranks last.
        ranked = np.concatenate([done, np.full(failed, np.inf)])
        p95 = float(ranked[max(0, math.ceil(0.95 * len(ranked)) - 1)]) * 1e3
        late = res["late"][~np.isnan(res["late"])]
        print(f"serve: {len(lat)} requests at {self.rate}/s, {failed} failed, p50 "
              f"{float(np.median(done)) * 1e3 if len(done) else float('nan')} ms, p95 {p95} ms, "
              f"sender late p95 {float(np.percentile(late, 95)) * 1e3 if len(late) else 0} ms, "
              f"window {res['elapsed']} s; errors {res['errors'][:3]}", file=sys.stderr)
        return Window(len(lat), failed, {"served_per_s": len(done) / res["elapsed"]}, len(lat),
                      res["elapsed"], {}, {"batches": batches, "batched_requests": requests}, {})

    def release(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.service.close()
        self.thread.join(30)
        if self.child is not None and self.child.is_alive():
            self.child.terminate()
            self.child.join(30)
        # Spawning the load generator started multiprocessing's resource
        # tracker, which would outlive the run by itself: stop it and wait.
        resource_tracker._resource_tracker._stop()
        del self.service, self.server
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        res = self.result
        pre, post, _ = inputs.image_pairs(self.seed, self.pool, self.cfg["image_size"])
        z = compare.reference_change_logits(self.cfg, self.params, pre, post, self.device)
        answers = [([int(res["pairs"][i])], m[None] > 127) for i, m in res["masks"].items()]
        want = min(self._tr["kept"], len(res["due"]))
        checks = compare.mask_checks(answers, z, self.limits, missing=want - len(answers))
        return checks + [Check("requests_failed", float(res["failed"] + res["stuck"]), 0.0)]
