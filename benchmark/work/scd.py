"""Work of the SCD model from its shapes alone, under ``flops.py``'s FLOP
convention: the five-frame encoder, two class heads and one binary head. The
fused blocks' least time is ``flops.fused_least_s``, which reads T from the
configuration's ``perception_frames``."""

from __future__ import annotations

from benchmark.work import flops


def scd_flops(cfg: dict) -> float:
    """One pair through the SCD forward: the encoder at T = perception
    frames + 2, ``decoder_pre`` and ``decoder_post`` at ``num_classes``
    outputs, ``decoder_change`` at one."""
    heads = [cfg["num_classes"], cfg["num_classes"], 1]
    return flops.encoder_flops(cfg) + sum(
        flops.change_decoder_flops(dict(cfg, num_classes=c)) for c in heads)
