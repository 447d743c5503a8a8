"""Open-loop load generator, run in a child process of the benchmark so that
it does not share the server's interpreter lock.

``rate * seconds`` requests arrive as a Poisson process of ``rate`` per
second conditioned on its count (``schedule``), each one uint8 pair of the
seeded pool sent on the raw wire (``POST /v1/predict``, ``Content-Type`` and ``Accept``
``application/octet-stream``, ``X-Height`` / ``X-Width``; masks back as
``X-Parts`` ``name:h:w``). Sender threads, each with its own keep-alive
connection, take the requests in order, wait for each one's due time and
send it; a request is timed from when it was due, so a stall delays the
requests behind it and counts against them. Imports numpy and the standard
library only."""

from __future__ import annotations

import http.client
import threading
import time

import numpy as np

from benchmark.benchlib import inputs

TIMEOUT_S = 60.0


def schedule(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the start) of round(rate * seconds) arrivals: one
    Poisson process of that count over ``seconds`` (uniform order
    statistics, the same for every seed), its gaps turned by an offset
    drawn from the seed, so every seed plays the same bursts in another
    order."""
    count = max(1, int(round(rate * seconds)))
    due = np.sort(np.random.default_rng(0).uniform(0.0, seconds, count))
    gaps = np.diff(due, prepend=0.0)
    return np.cumsum(np.roll(gaps, int(inputs.rng(seed, "arrivals").integers(count))))


def pair_of(seed: int, count: int, pool: int) -> np.ndarray:
    """The pool pair each request sends."""
    return inputs.rng(seed, "requests").integers(0, pool, count)


def _post(conn, body: bytes, h: int, w: int):
    conn.request("POST", "/v1/predict", body, {
        "Content-Type": "application/octet-stream", "Accept": "application/octet-stream",
        "X-Height": str(h), "X-Width": str(w)})
    r = conn.getresponse()
    data = r.read()
    if r.status != 200:
        raise RuntimeError(f"HTTP {r.status}: {data[:200]!r}")
    out, off = {}, 0
    for part in r.getheader("X-Parts").split(","):
        name, *dims = part.split(":")
        shape = tuple(int(d) for d in dims)
        n = int(np.prod(shape))
        out[name] = np.frombuffer(data[off:off + n], np.uint8).reshape(shape)
        off += n
    return out


def run(conn_pipe, port: int, seed: int, pool: int, size: int, rate: float, seconds: float,
        senders: int, keep: int) -> None:
    """The child's body: warm up, wait for 'go', play the schedule, send
    back per-request latencies and the masks of ``keep`` requests drawn
    from the seed."""
    pre, post, _ = inputs.image_pairs(seed, pool, size)
    bodies = [np.stack([pre[i], post[i]]).tobytes() for i in range(pool)]
    due = schedule(seed, rate, seconds)
    which = pair_of(seed, len(due), pool)
    kept = set(inputs.rng(seed, "kept").choice(len(due), min(keep, len(due)), replace=False)
               .tolist())
    lat = np.full(len(due), np.nan)
    sent = np.full(len(due), np.nan)
    errors, masks = [], {}
    lock, nxt = threading.Lock(), [0]
    warm = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    for i in range(2):
        _post(warm, bodies[i % pool], size, size)
    warm.close()
    conn_pipe.send("ready")
    if conn_pipe.recv() != "go":
        return
    t0 = time.perf_counter()

    def sender():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
        try:
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if i >= len(due):
                    return
                wait = t0 + due[i] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                sent[i] = time.perf_counter() - t0 - due[i]
                try:
                    out = _post(conn, bodies[which[i]], size, size)
                except (OSError, RuntimeError, http.client.HTTPException) as e:
                    errors.append(f"request {i}: {type(e).__name__}: {e}")
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
                    continue
                lat[i] = time.perf_counter() - t0 - due[i]
                if i in kept:
                    masks[i] = out["change"]
        finally:
            conn.close()

    threads = [threading.Thread(target=sender, daemon=True) for _ in range(senders)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(seconds + 2 * TIMEOUT_S)
    conn_pipe.send({"elapsed": time.perf_counter() - t0, "due": due, "latency": lat,
                    "late": sent, "pairs": which, "errors": errors[:20],
                    "failed": len(errors), "masks": masks,
                    "stuck": sum(t.is_alive() for t in threads)})
