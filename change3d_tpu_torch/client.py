"""Python client for ``cli serve`` (counterpart of ``change3d_tpu/client.py``):
the standard library, numpy and ``data/png.py`` only.

Images go in as uint8 arrays in the order they are stored on disk (BGR, as
``cv2.imread`` gives them) or as PNG file paths; masks come back as uint8
arrays (binary heads {0, 255}, class heads class ids), captions as strings.

    from change3d_tpu_torch.client import PredictClient
    c = PredictClient("http://127.0.0.1:8000")
    masks = c.predict("pre.png", "post.png")   # {"change": uint8 {0, 255}}
    print(c.health(), c.metrics())
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request
from typing import Dict, Union

import numpy as np

from change3d_tpu_torch.data.png import encode_png_bytes, read_png_bytes

ImageLike = Union[str, np.ndarray]


def _to_png_b64(img: ImageLike) -> str:
    if isinstance(img, str):
        with open(img, "rb") as f:
            return base64.b64encode(f.read()).decode("ascii")
    img = np.asarray(img, np.uint8)
    if img.ndim == 3:
        img = img[..., ::-1]  # BGR as stored -> the PNG's RGB
    return base64.b64encode(encode_png_bytes(img)).decode("ascii")


def _from_png_b64(b64: str) -> np.ndarray:
    try:
        return read_png_bytes(base64.b64decode(b64))
    except ValueError as e:
        raise ValueError(f"server returned an undecodable mask: {e}") from None


class PredictClient:
    """Blocking client; one instance may serve many threads (each call opens
    its own connection, and the server batches concurrent requests)."""

    def __init__(self, base_url: str, *, timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._task = None  # fetched from /healthz by the raw calls

    def _get(self, path: str) -> dict:
        with urllib.request.urlopen(self.base_url + path, timeout=self.timeout) as r:
            return json.loads(r.read())

    def health(self) -> dict:
        return self._get("/healthz")

    def metrics(self) -> dict:
        return self._get("/metrics")

    def _post(self, body: bytes, headers: Dict[str, str]):
        """(Content-Type, X-Parts, body) of a POST /v1/predict; RuntimeError
        with the server's reason on 4xx/5xx."""
        req = urllib.request.Request(self.base_url + "/v1/predict", body, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.headers.get("Content-Type", ""), r.headers.get("X-Parts"), r.read()
        except urllib.error.HTTPError as e:
            try:
                reason = json.loads(e.read()).get("error", str(e))
            except ValueError:  # not a JSON error body
                reason = str(e)
            raise RuntimeError(f"predict failed ({e.code}): {reason}") from e

    def predict(self, pre: ImageLike, post: ImageLike) -> Dict[str, Union[np.ndarray, str]]:
        """The task's masks as the server PNG-encodes them (binary heads
        {0, 255}: bcd/scd 'change', bda 'loc'; class ids: scd 'pre'/'post',
        bda 'cls'), or {'caption': str} from a CC server. Send images as
        stored on disk; the server applies the task's channel order."""
        body = json.dumps({"pre": _to_png_b64(pre), "post": _to_png_b64(post)}).encode()
        _, _, data = self._post(body, {"Content-Type": "application/json"})
        return {k: v if k == "caption" else _from_png_b64(v) for k, v in json.loads(data).items()}

    def _raw(self, pairs: np.ndarray, count: bool):
        """pairs: [N, 2, H, W, 3] uint8 as stored on disk (BGR). The raw wire
        carries the model's channel order, so non-BDA tasks flip to RGB here."""
        if self._task is None:
            self._task = self.health()["task"]
        if self._task != "bda":
            pairs = pairs[..., ::-1]
        n, _, h, w, _ = pairs.shape
        headers = {"Content-Type": "application/octet-stream",
                   "Accept": "application/octet-stream", "X-Height": str(h), "X-Width": str(w)}
        if count:
            headers["X-Count"] = str(n)
        ctype, parts, data = self._post(np.ascontiguousarray(pairs).tobytes(), headers)
        if ctype.startswith("application/json"):
            return json.loads(data)  # cc: {"caption": ...}
        return _parse_raw_parts(parts, data)

    def predict_raw(self, pre: np.ndarray, post: np.ndarray) -> Dict[str, Union[np.ndarray, str]]:
        """The codec-free wire: the uint8 pixels in one octet-stream body and
        the masks back the same way, byte-identical to :meth:`predict`. Same
        input convention as :meth:`predict` (BGR, as stored on disk)."""
        pre, post = np.asarray(pre, np.uint8), np.asarray(post, np.uint8)
        if pre.shape != post.shape or pre.ndim != 3 or pre.shape[-1] != 3:
            raise ValueError(f"need matching HWC uint8 images, got {pre.shape} / {post.shape}")
        return self._raw(np.stack([pre, post])[None], count=False)

    def predict_raw_many(self, pres: np.ndarray, posts: np.ndarray
                         ) -> Dict[str, Union[np.ndarray, list]]:
        """N pairs in one request (``X-Count``): masks back as [N, H, W]
        uint8 arrays (cc: {"caption": [str, ...]}), byte-identical to N
        :meth:`predict_raw` calls."""
        pres, posts = np.asarray(pres, np.uint8), np.asarray(posts, np.uint8)
        if pres.shape != posts.shape or pres.ndim != 4 or pres.shape[-1] != 3:
            raise ValueError(f"need matching NHWC uint8 stacks, got {pres.shape} / {posts.shape}")
        return self._raw(np.stack([pres, posts], axis=1), count=True)


def _parse_raw_parts(parts: str, data: bytes) -> Dict[str, np.ndarray]:
    """X-Parts ("name:d0:d1[:d2],...") and the concatenated uint8 body -> arrays."""
    out: Dict[str, np.ndarray] = {}
    off = 0
    for part in parts.split(","):
        name, *dims = part.split(":")
        shape = tuple(int(d) for d in dims)
        count = int(np.prod(shape))
        chunk = data[off:off + count]
        if len(chunk) != count:
            raise RuntimeError(f"truncated raw response: part {name!r} declares {count} bytes "
                               f"but only {len(chunk)} remain (X-Parts={parts!r}, body="
                               f"{len(data)} bytes)")
        out[name] = np.frombuffer(chunk, np.uint8).reshape(shape)
        off += count
    if off != len(data):
        raise RuntimeError(f"mis-framed raw response: X-Parts {parts!r} consumes {off} bytes but "
                           f"the body carries {len(data)}")
    return out
