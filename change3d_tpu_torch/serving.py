"""HTTP serving of a trained run (counterpart of ``change3d_tpu/serving.py``).

- **Batching onto a few fixed shapes**: requests queue, and one dispatcher
  thread gathers up to ``batch_size`` of them (waiting at most
  ``max_delay_ms`` after the first), pads the group to the smallest bucket
  that holds it by repeating its last pair, and runs one forward for the
  group. Detection buckets default to 1/4, 1/2 and all of ``batch_size``;
  every bucket is warmed up before the server exists.
- **Pipelined**: for detection the dispatcher only launches a batch
  (``Predictor.predict_u8_async``) and a completer thread waits for its
  masks (``finalize_u8``) and answers its requests, so one batch's fetch
  overlaps the next batch's forward; at most two batches are in flight.
- **JSON wire**: POST ``/v1/predict`` with base64 PNGs ``pre`` / ``post``;
  masks come back as base64 PNGs (CC: ``{"caption": str}``). The port
  decodes PNG only (``data/png.py``, no OpenCV): any other payload is
  answered 400 with that reason.
- **Raw wire**: the same endpoint with ``Content-Type:
  application/octet-stream``, ``X-Height`` / ``X-Width`` (and ``X-Count``
  for N pairs in one request) and a body of ``N*2*H*W*3`` uint8 bytes, pre
  then post, HWC, already in the task's channel order (RGB, BDA BGR). With
  ``Accept: application/octet-stream`` the masks come back as one uint8 body
  that ``X-Parts`` (``name:d0:d1[:d2],...``) describes.
- **Artifacts**: an exported artifact's predictor (``inference.py``
  ``ArtifactPredictor``, ``CaptionArtifactPredictor``) is served on the
  float path (the host normalises, ``predict`` / ``caption`` run without
  the pipelined launch); a pinned batch serves only that batch.
- **Tiled mode** (``tiled=True``): native-size scenes through
  :class:`~change3d_tpu_torch.inference.TiledPredictor`, one scene at a time.
- ``GET /healthz`` (readiness and configuration) and ``GET /metrics``
  (requests, errors, batches, mean fill, latency percentiles).
- **Tracing** (``profile_dir``, ``cli serve --profile_dir``): one
  ``torch.profiler`` trace of batches 10-14 after the warm-up, on every
  thread. Spans (``utils/profiling.py``) mark the dispatcher's
  ``c3d.serve.take`` (waiting for a batch), ``.stack`` (stack and pad),
  ``.launch`` and ``.inflight_wait`` (blocked while two batches are in
  flight); the completer's ``c3d.serve.finalize`` and ``.distribute``; a
  handler's ``c3d.serve.request`` with its parts ``.read``, ``.wait``
  (the service's answer) and ``.reply``.

A malformed request is answered 400, a body over ``MAX_BODY_BYTES`` 413,
and a failure of the forward 500 with its reason: the server never falls
back to the plain blocks or the CPU. Unlike the JAX handler, which replies
before it records, a request is recorded in ``/metrics`` before its reply
is sent, so a client that reads ``/metrics`` after its answer sees itself.

Channel order follows the training data: BCD, SCD and CC decode PNGs to RGB,
BDA stays BGR.
"""

from __future__ import annotations

import base64
import json
import math
import queue
import signal
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from change3d_tpu_torch.data.datasets import CaptionDataset
from change3d_tpu_torch.data.png import decode_png_bytes, encode_png_bytes
from change3d_tpu_torch.data.transforms import eval_normalize
from change3d_tpu_torch.utils.profiling import WindowTracer, span

# Largest accepted request body (two base64 PNGs).
MAX_BODY_BYTES = 256 * 1024 * 1024


class _Stats:
    """Lock-guarded serving counters and a latency ring buffer (seconds)."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._window = window
        self.reset()

    def reset(self):
        """Zero every counter (after the warm-up, so /metrics shows traffic)."""
        with self._lock:
            self.requests_total = 0
            self.errors_total = 0
            self.batches_total = 0
            self.batched_requests_total = 0
            self._latencies: Deque[float] = deque(maxlen=self._window)

    def record_request(self, seconds: float, ok: bool):
        with self._lock:
            self.requests_total += 1
            if not ok:
                self.errors_total += 1
            self._latencies.append(seconds)

    def record_batch(self, fill: int):
        with self._lock:
            self.batches_total += 1
            self.batched_requests_total += fill

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            # Nearest rank: ceil(p * n) - 1.
            q = lambda p: round(lat[max(0, math.ceil(p * len(lat)) - 1)], 4) if lat else None
            return {
                "requests_total": self.requests_total,
                "errors_total": self.errors_total,
                "batches_total": self.batches_total,
                "mean_batch_fill": (round(self.batched_requests_total / self.batches_total, 2)
                                    if self.batches_total else None),
                "latency_s": {"p50": q(0.50), "p90": q(0.90), "p99": q(0.99)},
            }


def decode_image(b64: str, *, to_rgb: bool) -> np.ndarray:
    """A base64 PNG -> [H, W, 3] uint8, BGR as cv2 decodes it, or RGB."""
    try:
        img = decode_png_bytes(base64.b64decode(b64, validate=True))
    except ValueError as e:
        raise ValueError(f"not a decodable PNG ({e}); this server accepts PNG images only") \
            from None
    return np.ascontiguousarray(img[:, :, ::-1]) if to_rgb else img


def encode_mask(mask: np.ndarray) -> str:
    return base64.b64encode(encode_png_bytes(mask.astype(np.uint8))).decode("ascii")


def masks_to_arrays(task: str, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Hardened per-image maps -> the uint8 arrays a response carries (the
    pixels ``cli predict`` writes)."""
    u8 = lambda a: np.ascontiguousarray(np.asarray(a).astype(np.uint8))
    if task == "bcd":
        return {"change": u8(out["change"] * 255)}
    if task == "scd":
        change = out["change"]
        return {"pre": u8(out["pre"] * change), "post": u8(out["post"] * change),
                "change": u8(change * 255)}
    return {"loc": u8(out["loc"] * 255), "cls": u8(out["cls"])}


def masks_to_payload(task: str, out: Dict[str, np.ndarray]) -> Dict[str, str]:
    """Hardened per-image maps -> base64-PNG response fields (CC: text)."""
    if task == "cc":
        return {"caption": str(out["caption"])}
    return {k: encode_mask(v) for k, v in masks_to_arrays(task, out).items()}


class _Batcher:
    """Gathers requests into fixed-size batches for one dispatcher thread.

    The dispatcher blocks on the first pending request, drains up to
    ``batch_size`` (waiting at most ``max_delay`` seconds for more), pads to
    the smallest bucket that holds them by repeating the last pair and runs
    ``predict_batch``. Given ``predict_async`` and ``finalize``, it only
    launches, and a completer thread finalizes and answers, with at most two
    batches in flight. The forward runs only on the dispatcher thread, under
    ``torch.inference_mode``. A ``tracer`` (``WindowTracer``) set after the
    warm-up is ticked once per batch, from 0.
    """

    def __init__(self, predict_batch, batch_size: int, max_delay: float,
                 stats: Optional[_Stats] = None, predict_async=None, finalize=None,
                 buckets: Optional[Tuple[int, ...]] = None):
        self._predict_batch = predict_batch
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets or (batch_size,)))
        if self.buckets[-1] != batch_size:
            raise ValueError(f"largest bucket {self.buckets[-1]} must equal batch_size "
                             f"{batch_size}")
        self.max_delay = max_delay
        self._stats = stats
        self._lock = threading.Condition()
        self._pending: List[dict] = []
        self._closed = False
        self._predict_async = predict_async if finalize is not None else None
        self._finalize = finalize
        self._inflight: Optional[queue.Queue] = None
        self._completer: Optional[threading.Thread] = None
        self.tracer: Optional[WindowTracer] = None
        self._traced = 0
        if self._predict_async is not None:
            self._inflight = queue.Queue(maxsize=2)
            self._completer = threading.Thread(target=self._complete, daemon=True)
            self._completer.start()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, pre: np.ndarray, post: np.ndarray) -> Dict[str, np.ndarray]:
        """Blocks until the request's batch is served; returns its maps or
        raises the batch's failure."""
        return self.submit_many([(pre, post)])[0]

    def submit_many(self, pairs) -> List[Dict[str, np.ndarray]]:
        """Enqueue many (pre, post) pairs at once and wait for all; they
        share batches with concurrent submitters."""
        items = [{"pre": p, "post": q, "event": threading.Event()} for p, q in pairs]
        with self._lock:
            if self._closed:
                raise RuntimeError("server is shut down")
            self._pending.extend(items)
            self._lock.notify()
        for item in items:
            item["event"].wait()
        for item in items:
            if "error" in item:
                raise item["error"]
        return [item["result"] for item in items]

    def close(self):
        """Serve what is pending, then stop both threads."""
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._thread.join(timeout=5)
        if self._completer is not None:
            self._completer.join(timeout=5)

    def _take_batch(self) -> List[dict]:
        with self._lock:
            while not self._pending and not self._closed:
                self._lock.wait()
            if self._closed and not self._pending:
                return []
            deadline = time.monotonic() + self.max_delay
            while len(self._pending) < self.batch_size and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._lock.wait(timeout=remaining)
            batch, self._pending = (self._pending[:self.batch_size],
                                    self._pending[self.batch_size:])
            return batch

    @staticmethod
    def _fail(batch: List[dict], e: Exception):
        for item in batch:
            item["error"] = e
            item["event"].set()

    @classmethod
    def _distribute(cls, batch: List[dict], out: Dict[str, np.ndarray]):
        with span("c3d.serve.distribute"):
            try:
                results = [{k: v[i] for k, v in out.items()} for i in range(len(batch))]
            except Exception as e:  # noqa: BLE001 — never leave a waiter hanging
                cls._fail(batch, e)
                return
            for item, res in zip(batch, results):
                item["result"] = res
                item["event"].set()

    @torch.inference_mode()
    def _run(self):
        while True:
            if self.tracer is not None:
                self.tracer.tick(self._traced)
                self._traced += 1
            with span("c3d.serve.take"):
                batch = self._take_batch()
            if not batch:
                if self.tracer is not None:
                    self.tracer.close()
                if self._inflight is not None:
                    self._inflight.put(None)
                return
            n = len(batch)
            if self._stats:
                self._stats.record_batch(n)
            try:
                with span("c3d.serve.stack"):
                    pre = np.stack([b["pre"] for b in batch])
                    post = np.stack([b["post"] for b in batch])
                    pad = min(b for b in self.buckets if b >= n) - n
                    if pad:
                        pre = np.concatenate([pre, np.repeat(pre[-1:], pad, 0)])
                        post = np.concatenate([post, np.repeat(post[-1:], pad, 0)])
                if self._predict_async is not None:
                    with span("c3d.serve.launch"):
                        handle = self._predict_async(pre, post)
                    # Blocks (bounded queue) while two batches are in flight.
                    with span("c3d.serve.inflight_wait"):
                        self._inflight.put((batch, handle))
                    continue
                out = self._predict_batch(pre, post)
            except Exception as e:  # noqa: BLE001 — failures go to each request
                self._fail(batch, e)
                continue
            self._distribute(batch, out)

    def _complete(self):
        while True:
            entry = self._inflight.get()
            if entry is None:
                return
            batch, handle = entry
            try:
                with span("c3d.serve.finalize"):
                    out = self._finalize(handle)
            except Exception as e:  # noqa: BLE001 — failures go to each request
                self._fail(batch, e)
                continue
            self._distribute(batch, out)


class _BadRequest(ValueError):
    pass


class PredictService:
    """Task-aware request handling over a ``Predictor`` (BCD, SCD, BDA), a
    ``CaptionPredictor`` (CC) or an exported artifact's predictor
    (``ArtifactPredictor``, ``CaptionArtifactPredictor``). A predictor with
    ``predict_u8`` / ``caption_u8`` is served uint8 end to end: pixels go to
    the card, normalisation and hardening run there, and bitpacked masks
    come back (pipelined for detection). Any other is served on the float
    path: the host normalises (``eval_normalize``; ImageNet's mean and std
    for CC) and ``predict`` / ``caption`` run batch by batch. An artifact
    pinned to a batch serves only that batch, in one bucket. A sharded
    predictor (``batch_divisor`` devices) serves only the buckets that
    divide over its devices, and refuses a ``batch_size`` that does not.
    ``warmup`` runs every bucket once (building the kernels) and one request through
    the batcher, then zeroes the statistics; start the HTTP server only
    after it. ``profile_dir`` traces the batcher's batches 10-14 after it
    (not in tiled mode, which has no batcher)."""

    def __init__(self, task: str, predictor, *, batch_size: int = 16,
                 max_delay_ms: float = 10.0, tiled: bool = False, tile_overlap: int = 32,
                 warmup: bool = False, buckets=None, profile_dir: Optional[str] = None):
        self.task = task
        self.to_rgb = task != "bda"  # BDA trains on BGR
        self.tiled = tiled
        self.batch_size = batch_size
        self.stats = _Stats()
        fixed = getattr(predictor, "fixed_batch", None)
        if fixed is not None and fixed != batch_size:
            raise ValueError(f"artifact was exported with a pinned batch of {fixed}; serve it "
                             f"with --batch_size {fixed} (got {batch_size})")
        if buckets is None:
            buckets = ((batch_size,) if fixed is not None or task == "cc" or tiled else
                       tuple(sorted({max(1, batch_size // 4), max(1, batch_size // 2),
                                     batch_size})))
        else:
            buckets = tuple(sorted({int(b) for b in buckets}))
            if not buckets or buckets[0] < 1 or buckets[-1] != batch_size:
                raise ValueError(f"buckets {buckets} must be positive and include batch_size "
                                 f"{batch_size} as the largest")
        # A sharded predictor splits every batch over its devices.
        divisor = getattr(predictor, "batch_divisor", 1)
        if batch_size % divisor != 0:
            raise ValueError(f"batch_size {batch_size} must be divisible by the sharded "
                             f"predictor's device count ({divisor})")
        kept = tuple(b for b in buckets if b % divisor == 0)
        if kept != buckets:
            print(f"[serving] dropping buckets {sorted(set(buckets) - set(kept))}: not divisible "
                  f"by the sharded predictor's device count ({divisor}); keeping {kept}",
                  flush=True)
        self.buckets = kept
        self.in_hw = (predictor.model.in_height, predictor.model.in_width)
        self._tiled = None
        self._batcher = None
        # Tile blending needs the soft float maps.
        self._u8 = not tiled and hasattr(predictor,
                                         "caption_u8" if task == "cc" else "predict_u8")
        if tiled:
            if task == "cc":
                raise ValueError("tiled serving applies to detection tasks only")
            if profile_dir:
                raise ValueError("profile_dir traces the batcher's batches; tiled serving "
                                 "has no batcher")
            from change3d_tpu_torch.inference import TiledPredictor

            self._tiled = TiledPredictor(predictor, overlap=tile_overlap, batch_size=batch_size)
            # One scene at a time: handler threads must not drive the card together.
            self._tiled_lock = threading.Lock()
        else:
            launch = finalize = None
            if task == "cc":
                caption = predictor.caption_u8 if self._u8 else predictor.caption

                def predict_batch(pre, post):
                    return {"caption": np.array(caption(pre, post), dtype=object)}
            elif self._u8:
                predict_batch = predictor.predict_u8
                launch, finalize = predictor.predict_u8_async, predictor.finalize_u8
            else:
                predict_batch = predictor.predict
            self._predict_batch = predict_batch
            self._batcher = _Batcher(predict_batch, batch_size, max_delay_ms / 1000.0,
                                     stats=self.stats, predict_async=launch, finalize=finalize,
                                     buckets=self.buckets)
        if warmup and not tiled:
            dtype = np.uint8 if self._u8 else np.float32
            with torch.inference_mode():
                for b in self.buckets:
                    z = np.zeros((b,) + self.in_hw + (3,), dtype)
                    self._predict_batch(z, z)
            z = np.zeros(self.in_hw + (3,), dtype)
            self._batcher.submit(z, z)
            self.stats.reset()
        if profile_dir:
            self._batcher.tracer = WindowTracer(profile_dir)

    def _norm(self, img: np.ndarray) -> np.ndarray:
        """uint8 HWC in the task's channel order -> what the predictor takes:
        the pixels themselves on the uint8 path, normalised floats on the
        float path."""
        if self._u8:
            return np.ascontiguousarray(img)
        if self.task == "cc":
            return (img.astype(np.float32) / 255.0 - CaptionDataset.MEAN) / CaptionDataset.STD
        return eval_normalize(img)

    def _predict_maps(self, pre: np.ndarray, post: np.ndarray) -> Dict[str, np.ndarray]:
        """uint8 HWC pairs in the task's channel order -> hardened maps."""
        if pre.shape != post.shape:
            raise _BadRequest(f"pre {pre.shape} != post {post.shape}")
        if self.tiled:
            with self._tiled_lock:
                return self._tiled.predict_scene(eval_normalize(pre), eval_normalize(post))
        if pre.shape[:2] != self.in_hw:
            raise _BadRequest(f"image is {pre.shape[:2]}, model expects {self.in_hw} "
                              "(start the server with --tiled for native-size scenes)")
        return self._batcher.submit(self._norm(pre), self._norm(post))

    def handle(self, body: dict) -> Dict[str, str]:
        """A JSON request body -> the JSON response fields."""
        try:
            pre = decode_image(body["pre"], to_rgb=self.to_rgb)
            post = decode_image(body["post"], to_rgb=self.to_rgb)
        except (KeyError, ValueError, TypeError) as e:
            raise _BadRequest(f"bad pre/post image: {e}") from e
        return masks_to_payload(self.task, self._predict_maps(pre, post))

    def handle_raw(self, raw: bytes, headers):
        """A raw-wire body (``N*2*H*W*3`` uint8 bytes; see the module
        docstring) -> per-task uint8 arrays, with a leading N axis when
        ``X-Count`` is given (CC: ``{"caption": str or [str, ...]}``)."""
        try:
            h = int(headers.get("X-Height", ""))
            w = int(headers.get("X-Width", ""))
            n = int(headers.get("X-Count", "1"))
        except ValueError as e:
            raise _BadRequest("raw requests need integer X-Height/X-Width (and optional "
                              "X-Count) headers") from e
        if h <= 0 or w <= 0 or n <= 0:
            raise _BadRequest(f"bad raw dims {n}x{h}x{w}")
        if len(raw) != n * 2 * h * w * 3:
            prefix = f"{n}*" if "X-Count" in headers else ""
            raise _BadRequest(f"raw body is {len(raw)} bytes, expected {prefix}2*{h}*{w}*3 = "
                              f"{n * 2 * h * w * 3} (per pair: pre then post, uint8 HWC)")
        bulk = "X-Count" in headers
        if bulk and self.tiled:
            raise _BadRequest("bulk (X-Count) is for the batched endpoint; tiled servers take "
                              "one scene per request")
        pairs = np.frombuffer(raw, np.uint8).reshape(n, 2, h, w, 3)
        if not bulk:
            out = self._predict_maps(pairs[0, 0], pairs[0, 1])
            return ({"caption": str(out["caption"])} if self.task == "cc"
                    else masks_to_arrays(self.task, out))
        if (h, w) != self.in_hw:
            raise _BadRequest(f"images are {(h, w)}, model expects {self.in_hw}")
        outs = self._batcher.submit_many((self._norm(pairs[i, 0]), self._norm(pairs[i, 1]))
                                          for i in range(n))
        if self.task == "cc":
            return {"caption": [str(o["caption"]) for o in outs]}
        per_pair = [masks_to_arrays(self.task, o) for o in outs]
        return {k: np.stack([p[k] for p in per_pair]) for k in per_pair[0]}

    def health(self) -> dict:
        return {"status": "ok", "task": self.task, "batch_size": self.batch_size,
                "buckets": list(self.buckets), "tiled": self.tiled,
                "input_hw": list(self.in_hw)}

    def close(self):
        if self._batcher:
            self._batcher.close()


def make_server(service: PredictService, host: str = "0.0.0.0", port: int = 8000):
    """Build (not start) a ThreadingHTTPServer around a PredictService."""

    class Handler(BaseHTTPRequestHandler):
        # A half-open connection must not pin a handler thread forever.
        timeout = 120
        protocol_version = "HTTP/1.1"  # keep-alive; every reply sets Content-Length

        def _send(self, code: int, data: bytes, headers: Dict[str, str]):
            self.send_response(code)
            for k, v in headers.items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _json(self, code: int, payload: dict):
            return code, json.dumps(payload).encode(), {"Content-Type": "application/json"}

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._send(*self._json(200, service.health()))
            elif self.path == "/metrics":
                self._send(*self._json(200, service.stats.snapshot()))
            else:
                self._send(*self._json(404, {"error": f"unknown path {self.path}"}))

        def _answer(self):
            """(code, body, headers) of a POST /v1/predict."""
            length = int(self.headers.get("Content-Length", 0))
            if length > MAX_BODY_BYTES:
                # The body stays unread: drop the connection, or keep-alive
                # would read it as the next request.
                self.close_connection = True
                return self._json(413, {"error": (
                    f"body {length} bytes exceeds the {MAX_BODY_BYTES} limit (tile large "
                    "scenes client-side, or raise serving.MAX_BODY_BYTES)")})
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
            with span("c3d.serve.request.read"):
                body = self.rfile.read(length)
            with span("c3d.serve.request.wait"):
                if ctype != "application/octet-stream":
                    return self._json(200, service.handle(json.loads(body)))
                out = service.handle_raw(body, self.headers)
            if "caption" in out:
                return self._json(200, out)
            if "application/octet-stream" in self.headers.get("Accept", ""):
                parts = ",".join(f"{k}:" + ":".join(str(d) for d in v.shape)
                                 for k, v in out.items())
                return 200, b"".join(v.tobytes() for v in out.values()), {
                    "Content-Type": "application/octet-stream", "X-Parts": parts}
            if any(v.ndim > 2 for v in out.values()):
                return self._json(400, {"error": "bulk (X-Count) detection responses are raw "
                                                 "only: send Accept: application/octet-stream"})
            return self._json(200, {k: encode_mask(v) for k, v in out.items()})

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/predict":
                self.close_connection = True  # the body stays unread
                self._send(*self._json(404, {"error": f"unknown path {self.path}"}))
                return
            t0 = time.monotonic()
            with span("c3d.serve.request"):
                try:
                    reply = self._answer()
                except _BadRequest as e:
                    reply = self._json(400, {"error": str(e)})
                except json.JSONDecodeError as e:
                    reply = self._json(400, {"error": f"bad JSON: {e}"})
                except Exception as e:  # noqa: BLE001 — 500 with the reason
                    self.close_connection = True  # socket state unknown
                    reply = self._json(500, {"error": f"{type(e).__name__}: {e}"})
                # Recorded before the reply leaves, so /metrics read after the
                # answer counts this request.
                service.stats.record_request(time.monotonic() - t0, reply[0] == 200)
                with span("c3d.serve.request.reply"):
                    self._send(*reply)

        def log_message(self, fmt, *args):  # health checks are chatty
            pass

    class Server(ThreadingHTTPServer):
        # Bursts of many clients overflow the default backlog of 5. Handler
        # threads are joined by server_close(), so finished batches are
        # fully answered before shutdown completes.
        request_queue_size = 1024
        daemon_threads = False

    return Server((host, port), Handler)


def serve_forever(service: PredictService, host: str, port: int):
    """Serve until SIGTERM or Ctrl-C, then drain: stop accepting, answer the
    requests in flight, stop the dispatcher."""
    httpd = make_server(service, host, port)
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=httpd.shutdown, daemon=True).start())
    print(f"serving {service.task} on http://{host}:{httpd.server_address[1]} "
          f"(batch {service.batch_size}, buckets {list(service.buckets)}, tiled={service.tiled})",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()
        print("server stopped", flush=True)
