"""The system under test: the port (``change3d_tpu_torch``) built from a
configuration file, with the benchmark's seeded weights loaded into it."""

from __future__ import annotations

import torch


def build_model(cfg: dict, params: dict, device):
    """The port's ``Change3D`` for ``cfg`` on ``device`` holding ``params``
    (the benchmark's weights, every key of the model's state_dict)."""
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3DConfig

    backbone = X3DConfig(
        stem_dim_out=cfg["stem_dim"], stage_dims=tuple(cfg["stage_dims"]),
        stage_inner_dims=tuple(cfg["stage_inner_dims"]), stage_depths=tuple(cfg["stage_depths"]),
        se_ratio=cfg["se_ratio"], bn_eps=cfg["bn_eps"])
    kw = {}
    if cfg["task"] == "cc":
        kw = dict(vocab_size=cfg["vocab_size"], embed_dim=cfg["embed_dim"],
                  num_heads=cfg["num_heads"], num_layers=cfg["num_layers"],
                  dropout=cfg["dropout"])
    model = Change3D(Task(cfg["task"]), num_classes=cfg["num_classes"],
                     in_height=cfg["image_size"], in_width=cfg["image_size"],
                     backbone_cfg=backbone, device=device, **kw)
    with torch.no_grad():
        model.load_state_dict(params, strict=True)
    return model


def word_map(vocab_size: int) -> dict:
    """The seeded stand-in for LEVIR-CC's word map: the four special tokens,
    then one made-up word per remaining id."""
    words = {"<pad>": 0, "<unk>": 1, "<start>": 2, "<end>": 3}
    words.update({f"w{i}": i for i in range(4, vocab_size)})
    return words
