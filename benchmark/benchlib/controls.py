"""Stand-ins for the program used by the controls only (never by a
benchmark run): the plain reference with float8 products behind the
surface a driver calls."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark.reference.change3d import Change3DRef, normalize_u8


class Fp8Predictor:
    """``Predictor.predict_u8`` (and the launch / finalize pair the server
    pipelines) computed by the reference with float8 products."""

    def __init__(self, cfg, params, device):
        self.ref, self.device = Change3DRef(cfg, params, quant="fp8"), device
        self.model = SimpleNamespace(in_height=cfg["image_size"], in_width=cfg["image_size"])

    @torch.no_grad()
    def predict_u8(self, pre, post):
        put = lambda a: normalize_u8(torch.from_numpy(a).to(self.device), "bcd")
        return {"change": (self.ref.change_logits(put(pre), put(post)) > 0).cpu().numpy()}

    def predict_u8_async(self, pre, post):
        return self.predict_u8(pre, post)

    @staticmethod
    def finalize_u8(launch):
        return launch
