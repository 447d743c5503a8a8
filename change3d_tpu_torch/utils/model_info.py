"""Model efficiency report (counterpart of ``change3d_tpu/utils/model_info.py``):
parameter counts and FLOPs per task, beside the reference's published table.

- ``params_total`` and its breakdown count every parameter of the task's
  ``Change3D`` (buffers such as BN statistics are not parameters). The port
  builds what the task runs, as flax does: detection stops at stage 3, CC
  runs stage 4 without the enhancement convs, and no task builds the
  Kinetics head. The paper's convention leaves the perception frames out
  (``params_excl_perception``).
- ``flops_per_sample`` comes from ``torch.utils.flop_counter.FlopCounterMode``
  over one batch-1 eval forward with every block on its plain PyTorch
  version (the fused CUDA kernels compute the same function, but a launch
  through ctypes is invisible to the counter). The counter counts only
  matrix products and convolutions, 2 flops per multiply-add: ``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``convolution`` (grouped and transposed
  included) and the fused attention kernels. It differs from the JAX
  report's XLA cost analysis in two ways that pull opposite ways (together
  about 1% at 64², bcd +1.1%, scd -0.1%, cc +0.9%): it counts every kernel
  tap of every output, the taps that fall on zero padding included (and,
  for a transposed conv, every input-by-kernel product, those cropped by its
  padding included), where XLA counts in-bounds taps only (a 3x3x3
  depthwise conv on [1, 3, 8, 8, 16]: 165,888 against 108,416); and it
  leaves out elementwise work (BN folds, ReLU, swish, the SE pooling,
  sigmoid, softmax, the |pre - post| difference, LayerNorm), which XLA
  counts. ``macs_per_sample`` is half of it, the number to set beside the
  paper's "FLOPs".
- Caption FLOPs are for the teacher-forced forward over a
  ``max_caption_len``-token caption, as in the JAX report.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

# Published reference efficiency rows (BASELINE.md; the paper's tables).
REFERENCE_EFFICIENCY = {
    "bcd": {"params_m": 1.54, "gflops": 8.29, "inference_s": 0.015},
    "scd": {"params_m": 1.66, "gflops": 15.19, "inference_s": 0.018},
    "bda": {"params_m": 1.60, "gflops": 11.74, "inference_s": 0.016},
    "cc": {"params_m": 5.05, "gflops": 2.39, "inference_s": 0.007},
}


def tree_size(tensors: Iterable[torch.Tensor]) -> int:
    """Values held by ``tensors``."""
    return int(sum(t.numel() for t in tensors))


def params_breakdown(params: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Named parameters -> counts of the backbone, the perception frames,
    the enhancement convs and the task heads."""
    part = lambda prefix: tree_size(v for k, v in params.items() if k.startswith(prefix))
    return {
        "backbone": part("encoder.x3d."),
        "perception_frames": part("encoder.perception_frames"),
        "enhance_fc": part("encoder.fc"),
        "heads": part("decoder"),
    }


def model_info(task: str, *, num_classes: Optional[int] = None, in_height: int = 256,
               in_width: int = 256, vocab_size: int = 500, embed_dim: int = 192,
               n_head: int = 8, n_layer: int = 3, max_caption_len: int = 52, seed: int = 0,
               backbone_cfg=None, device="cuda") -> Dict[str, Any]:
    """The efficiency report of one task configuration, counted on
    ``device`` (the card by default; ``device="cpu"`` needs none)."""
    import dataclasses

    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import x3d_l_config

    if num_classes is None:
        num_classes = {"bcd": 1, "scd": 6, "bda": 5, "cc": 1}[task]
    cfg = dataclasses.replace(backbone_cfg or x3d_l_config(), fused_inference=False)
    model = Change3D(Task(task), num_classes=num_classes, in_height=in_height,
                     in_width=in_width, backbone_cfg=cfg,
                     vocab_size=vocab_size if task == "cc" else 0, embed_dim=embed_dim,
                     num_heads=n_head, num_layers=n_layer, device=device, seed=seed).eval()
    dev = next(model.parameters()).device
    pre = torch.zeros((1, in_height, in_width, 3), device=dev)
    extra = ((torch.zeros((1, max_caption_len), dtype=torch.long, device=dev),)
             if task == "cc" else ())
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        model(pre, pre, *extra)
    flops = float(counter.get_total_flops())

    params = dict(model.named_parameters())
    total = tree_size(params.values())
    breakdown = params_breakdown(params)
    report: Dict[str, Any] = {
        "task": task,
        "input": [in_height, in_width],
        "params_total": total,
        "params_excl_perception": total - breakdown["perception_frames"],
        "params_breakdown": breakdown,
        "flops_per_sample": flops,
        "macs_per_sample": flops / 2.0,
        "flop_counter": "torch.utils.flop_counter.FlopCounterMode (matmuls and convolutions)",
    }
    ref = REFERENCE_EFFICIENCY.get(task)
    if ref and in_height == 256 and in_width == 256:
        report["reference"] = dict(ref)
        report["params_m"] = round(report["params_excl_perception"] / 1e6, 3)
        report["gmacs"] = round(flops / 2.0 / 1e9, 3)
    return report


def format_info(report: Dict[str, Any]) -> str:
    bd = report["params_breakdown"]
    lines = [
        f"task: {report['task']}  input: {report['input'][0]}x{report['input'][1]}",
        f"params: {report['params_total']:,} "
        f"(backbone {bd['backbone']:,} / perception {bd['perception_frames']:,} "
        f"/ enhance {bd['enhance_fc']:,} / heads {bd['heads']:,})",
        f"params excl. perception frames (paper convention): "
        f"{report['params_excl_perception']:,}",
        f"FLOPs per sample (matmuls and convolutions): {report['flops_per_sample'] / 1e9:.3f} G "
        f"({report['macs_per_sample'] / 1e9:.3f} GMACs)",
    ]
    ref = report.get("reference")
    if ref:
        lines.append(f"reference (paper): {ref['params_m']} M params, {ref['gflops']} G, "
                     f"{ref['inference_s']} s/sample")
    return "\n".join(lines)
