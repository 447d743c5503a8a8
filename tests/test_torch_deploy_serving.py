"""``serving.py`` and ``client.py`` of the port on the CPU, held against the
JAX serving stack: the batcher's padding, buckets, pipelining, error
propagation and close; ``_Stats`` against JAX's; the port's server against
the JAX ``PredictService`` over HTTP on 127.0.0.1 on the same bridged TINY
BCD weights, JSON and raw wires; 400 / 404 / 413 / 500 answers; the client
reading ``/metrics`` right after each answer; CC serving; the SCD and BDA
payload fields and BDA's channel order."""

import base64
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu import serving as jax_serving
from change3d_tpu_torch import serving
from change3d_tpu_torch.client import PredictClient, _parse_raw_parts
from change3d_tpu_torch.data.png import encode_png_bytes
from change3d_tpu_torch.inference import CaptionPredictor
from change3d_tpu_torch.serving import PredictService, _Batcher, _Stats, make_server

from tests.test_torch_cc_model import cc_pair
from tests.test_torch_cc_predict import WORDS
from tests.test_torch_deploy_tiling_predict import bridged

HW = 16


@pytest.fixture(autouse=True)
def _two_threads():
    """Tiny forwards: many intra-op threads per test process only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# -- batcher and statistics ---------------------------------------------------

def _submit_all(batcher, xs):
    results = [None] * len(xs)
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, batcher.submit(xs[i], xs[i]))) for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    return results


@pytest.mark.parametrize("pipelined", [False, True])
def test_batcher_pads_to_the_smallest_bucket(pipelined):
    seen = []

    def predict_batch(pre, post):
        seen.append(pre.shape[0])
        return {"m": pre.sum(axis=(1, 2, 3))}

    kw = dict(predict_async=lambda pre, post: predict_batch(pre, post),
              finalize=lambda out: out) if pipelined else {}
    b = _Batcher(predict_batch, batch_size=8, max_delay=0.05, buckets=(2, 4, 8), **kw)
    xs = [np.full((2, 2, 3), i, np.float32) for i in range(3)]
    results = _submit_all(b, xs)
    b.close()
    for i in range(3):  # each request gets its own row back
        np.testing.assert_allclose(results[i]["m"], xs[i].sum())
    assert seen and all(s in (2, 4) for s in seen)
    many = _Batcher(predict_batch, batch_size=4, max_delay=0.01, **kw)
    seen.clear()
    out = many.submit_many([(x, x) for x in xs * 3])  # 9 pairs: 4 + 4 + 1 padded to 4
    many.close()
    assert [o["m"] for o in out] == [x.sum() for x in xs * 3] and seen == [4, 4, 4]
    with pytest.raises(ValueError, match="must equal batch_size"):
        _Batcher(predict_batch, batch_size=8, max_delay=0.01, buckets=(2, 4))


@pytest.mark.parametrize("where", ["predict", "finalize"])
def test_batcher_propagates_errors_and_refuses_after_close(where):
    def fail(*_):
        raise RuntimeError("card on fire")

    ok = lambda pre, post: {"m": pre.sum(axis=(1, 2, 3))}
    b = (_Batcher(fail, batch_size=2, max_delay=0.01) if where == "predict" else
         _Batcher(ok, batch_size=2, max_delay=0.01, predict_async=ok, finalize=fail))
    with pytest.raises(RuntimeError, match="card on fire"):
        b.submit(np.zeros((2, 2, 3)), np.zeros((2, 2, 3)))
    b.close()
    assert not b._thread.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        b.submit(np.zeros((2, 2, 3)), np.zeros((2, 2, 3)))


def test_batcher_forward_runs_under_inference_mode():
    modes = []
    b = _Batcher(lambda pre, post: modes.append(torch.is_inference_mode_enabled()) or
                 {"m": pre[:, 0, 0, 0]}, batch_size=1, max_delay=0.0)
    b.submit(np.zeros((1, 1, 3)), np.zeros((1, 1, 3)))
    b.close()
    assert modes == [True]


def test_stats_equal_jax_stats():
    ours, theirs = _Stats(), jax_serving._Stats()
    rs = np.random.RandomState(0)
    for n in (1, 2, 7, 100, 1500):  # past the 1024 window too
        for s in (ours, theirs):
            s.reset()
        for i in range(n):
            sec, ok = float(rs.exponential(0.05)), bool(rs.rand() < 0.9)
            for s in (ours, theirs):
                s.record_request(sec, ok)
                if i % 3 == 0:
                    s.record_batch(1 + i % 4)
        assert ours.snapshot() == theirs.snapshot()
    ours.reset()
    assert ours.snapshot()["latency_s"] == {"p50": None, "p90": None, "p99": None}


# -- HTTP ---------------------------------------------------------------------

class Served:
    """A service behind a server on 127.0.0.1 (any free port), in a thread."""

    def __init__(self, service):
        self.service = service
        self.httpd = make_server(service, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture
def serve():
    started = []

    def start(service):
        started.append(Served(service))
        return started[-1]

    yield start
    for s in started:
        s.close()


def _post(url, body: bytes, headers):
    req = urllib.request.Request(url + "/v1/predict", body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _b64png(img):
    return base64.b64encode(encode_png_bytes(img)).decode()


@pytest.fixture(scope="module")
def bcd_pair():
    return bridged("bcd", seed=11, h=HW, w=HW)


def _images(seed, n):
    rs = np.random.RandomState(seed)
    return [tuple(rs.randint(0, 256, (HW, HW, 3)).astype(np.uint8) for _ in range(2))
            for _ in range(n)]


def test_port_server_answers_as_the_jax_server(bcd_pair, serve):
    """The same requests to both servers on the same weights (JSON and raw,
    single and bulk): masks equal wherever JAX's probability is further than
    1e-4 from 0.5."""
    jpred, pred = bcd_pair
    ours = serve(PredictService("bcd", pred, batch_size=4, max_delay_ms=5, warmup=True))
    theirs = serve(jax_serving.PredictService("bcd", jpred, batch_size=4, max_delay_ms=5,
                                              warmup=True))
    assert ours.service.buckets == theirs.service.buckets == (1, 2, 4)
    pairs = _images(1, 5)
    pres = np.stack([p for p, _ in pairs])
    posts = np.stack([q for _, q in pairs])
    norm = lambda a: (a.astype(np.float32) / 255.0 - 0.5) / 0.5
    prob = jpred.predict_probs(norm(pres[..., ::-1]), norm(posts[..., ::-1]))["change"][..., 0]
    decided = np.abs(prob - 0.5) > 1e-4
    print(f"share of pixels compared: {decided.mean():.6f}")
    assert decided.mean() > 0.99
    answers = {}
    for name, served in (("ours", ours), ("theirs", theirs)):
        c = PredictClient(served.url)
        json_masks = np.stack([c.predict(p, q)["change"] for p, q in pairs])
        raw_masks = np.stack([c.predict_raw(p, q)["change"] for p, q in pairs])
        bulk = c.predict_raw_many(pres, posts)["change"]
        np.testing.assert_array_equal(json_masks, raw_masks)
        np.testing.assert_array_equal(raw_masks, bulk)
        answers[name] = raw_masks
        assert c.health()["task"] == "bcd"
    assert set(np.unique(answers["ours"])) <= {0, 255}
    np.testing.assert_array_equal(answers["ours"][decided], answers["theirs"][decided])
    # The port's masks are exactly its direct predict_u8's (RGB order on the wire).
    direct = pred.predict_u8(pres[..., ::-1].copy(), posts[..., ::-1].copy())["change"]
    np.testing.assert_array_equal(answers["ours"], direct.astype(np.uint8) * 255)


def test_bad_requests(bcd_pair, serve, monkeypatch):
    _, pred = bcd_pair
    served = serve(PredictService("bcd", pred, batch_size=2, max_delay_ms=1))
    url = served.url
    ok = _b64png(np.zeros((HW, HW, 3), np.uint8))
    jpeg = base64.b64encode(b"\xff\xd8\xff\xe0" + bytes(64)).decode()
    raw_headers = {"Content-Type": "application/octet-stream", "X-Height": str(HW),
                   "X-Width": str(HW)}
    cases = [
        (b"{not json", {"Content-Type": "application/json"}, 400, "bad JSON"),
        (json.dumps({"pre": ok}).encode(), {}, 400, "bad pre/post"),
        (json.dumps({"pre": ok, "post": "@@@"}).encode(), {}, 400, "bad pre/post"),
        (json.dumps({"pre": ok, "post": jpeg}).encode(), {}, 400, "PNG images only"),
        (json.dumps({"pre": ok, "post": _b64png(np.zeros((8, 8, 3), np.uint8))}).encode(), {},
         400, "pre (16, 16, 3) != post"),
        (json.dumps({"pre": _b64png(np.zeros((8, 8, 3), np.uint8)),
                     "post": _b64png(np.zeros((8, 8, 3), np.uint8))}).encode(), {}, 400,
         "--tiled"),
        (bytes(10), raw_headers, 400, "raw body is 10 bytes"),
        (bytes(10), {**raw_headers, "X-Height": "x"}, 400, "integer X-Height"),
        (bytes(0), {**raw_headers, "X-Width": "0"}, 400, "bad raw dims"),
        (bytes(2 * 2 * HW * HW * 3), {**raw_headers, "X-Count": "2"}, 400, "raw only"),
    ]
    for body, headers, code, reason in cases:
        status, _, data = _post(url, body, headers)
        assert status == code and reason in json.loads(data)["error"], (reason, data)
    req = urllib.request.Request(url + "/nowhere")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 404
    monkeypatch.setattr(serving, "MAX_BODY_BYTES", 100)
    status, _, data = _post(url, bytes(200), raw_headers)
    assert status == 413 and "exceeds" in json.loads(data)["error"]
    snap = PredictClient(url).metrics()
    assert snap["requests_total"] == len(cases) + 1 and snap["errors_total"] == len(cases) + 1


def test_a_failing_forward_answers_500_without_a_fallback(bcd_pair, serve):
    _, pred = bcd_pair

    class Broken:
        model = pred.model

        def predict_u8(self, pre, post):
            raise RuntimeError("fused_block_fwd failed: CUDA error 700")

        predict_u8_async = predict_u8
        finalize_u8 = staticmethod(lambda launch: launch)

    served = serve(PredictService("bcd", Broken(), batch_size=2, max_delay_ms=1))
    with pytest.raises(RuntimeError, match=r"\(500\): RuntimeError: fused_block_fwd failed"):
        PredictClient(served.url).predict_raw(*_images(2, 1)[0])


def test_client_reads_metrics_right_after_each_answer(bcd_pair, serve, tmp_path):
    _, pred = bcd_pair
    served = serve(PredictService("bcd", pred, batch_size=2, max_delay_ms=1, warmup=True))
    c = PredictClient(served.url)
    assert c.metrics()["requests_total"] == 0  # the warm-up is not counted
    pre, post = _images(3, 1)[0]
    path = str(tmp_path / "pre.png")
    with open(path, "wb") as f:
        f.write(encode_png_bytes(pre[..., ::-1]))  # stored on disk: RGB PNG of a BGR array
    for i in range(1, 13):
        out = (c.predict(path, post) if i % 3 == 0 else
               c.predict(pre, post) if i % 3 == 1 else c.predict_raw(pre, post))
        assert out["change"].shape == (HW, HW)
        snap = c.metrics()
        assert snap["requests_total"] == i and snap["errors_total"] == 0
    assert snap["batches_total"] == 12 and snap["latency_s"]["p50"] is not None


@pytest.mark.parametrize("task", ["scd", "bda"])
def test_scd_and_bda_payload_fields(task, serve):
    _, pred = bridged(task, seed=12, h=HW, w=HW)
    served = serve(PredictService(task, pred, batch_size=2, max_delay_ms=1))
    assert served.service.to_rgb == (task != "bda")
    c = PredictClient(served.url)
    pre, post = _images(4, 1)[0]  # as stored on disk, BGR
    json_out, raw_out = c.predict(pre, post), c.predict_raw(pre, post)
    fields = {"scd": {"pre", "post", "change"}, "bda": {"loc", "cls"}}[task]
    assert set(json_out) == set(raw_out) == fields
    order = (lambda a: a) if task == "bda" else (lambda a: a[..., ::-1].copy())
    direct = pred.predict_u8(order(pre)[None], order(post)[None])
    want = serving.masks_to_arrays(task, {k: v[0] for k, v in direct.items()})
    for key in fields:
        np.testing.assert_array_equal(json_out[key], want[key])
        np.testing.assert_array_equal(raw_out[key], want[key])
    change = want["change"] if task == "scd" else want["loc"]
    assert set(np.unique(change)) <= {0, 255}


def test_tiled_service_serves_a_scene(bcd_pair, serve):
    _, pred = bcd_pair
    served = serve(PredictService("bcd", pred, batch_size=3, tiled=True, tile_overlap=4))
    assert served.service.buckets == (3,)
    rs = np.random.RandomState(5)
    pre, post = (rs.randint(0, 256, (40, 28, 3)).astype(np.uint8) for _ in range(2))
    out = PredictClient(served.url).predict_raw(pre, post)
    from change3d_tpu_torch.inference import TiledPredictor

    norm = lambda a: (a[..., ::-1].astype(np.float32) / 255.0 - 0.5) / 0.5
    want = TiledPredictor(pred, overlap=4, batch_size=3).predict_scene(norm(pre), norm(post))
    np.testing.assert_array_equal(out["change"], want["change"].astype(np.uint8) * 255)
    status, _, data = _post(served.url, bytes(2 * 2 * 40 * 28 * 3),
                            {"Content-Type": "application/octet-stream", "X-Height": "40",
                             "X-Width": "28", "X-Count": "2"})
    assert status == 400 and "tiled servers" in json.loads(data)["error"]


def test_caption_serving(serve):
    _, _, model = cc_pair(True, seed=13)
    pred = CaptionPredictor(model, WORDS, beam_size=1, compute_dtype=torch.float32, device="cpu")
    served = serve(PredictService("cc", pred, batch_size=2, max_delay_ms=1, warmup=True))
    assert served.service.buckets == (2,)
    hw = model.in_height
    rs = np.random.RandomState(6)
    pairs = [tuple(rs.randint(0, 256, (hw, hw, 3)).astype(np.uint8) for _ in range(2))
             for _ in range(3)]
    c = PredictClient(served.url)
    for pre, post in pairs:
        want = pred.caption_u8(pre[None, ..., ::-1].copy(), post[None, ..., ::-1].copy())[0]
        assert c.predict(pre, post) == {"caption": want}
        assert c.predict_raw(pre, post) == {"caption": want}
    many = c.predict_raw_many(np.stack([p for p, _ in pairs]), np.stack([q for _, q in pairs]))
    assert many["caption"] == [c.predict_raw(p, q)["caption"] for p, q in pairs]
    with pytest.raises(ValueError, match="detection tasks only"):
        PredictService("cc", pred, tiled=True)


def test_parse_raw_parts_checks_the_framing():
    out = _parse_raw_parts("a:2:3,b:1:2:2", bytes(range(10)))
    assert out["a"].shape == (2, 3) and out["b"].shape == (1, 2, 2)
    with pytest.raises(RuntimeError, match="truncated"):
        _parse_raw_parts("a:4:4", bytes(3))
    with pytest.raises(RuntimeError, match="mis-framed"):
        _parse_raw_parts("a:1:1", bytes(3))


def test_service_buckets(bcd_pair):
    _, pred = bcd_pair
    svc = PredictService("bcd", pred, batch_size=16, max_delay_ms=1)
    assert svc.buckets == (4, 8, 16)
    svc.close()
    svc = PredictService("bcd", pred, batch_size=16, buckets=(16, 8))
    assert svc.buckets == (8, 16)
    svc.close()
    with pytest.raises(ValueError, match="include batch_size"):
        PredictService("bcd", pred, batch_size=16, buckets=(4, 8))
