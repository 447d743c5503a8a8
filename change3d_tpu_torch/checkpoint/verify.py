"""Kinetics checkpoint parity harness (counterpart of
``change3d_tpu/checkpoint/verify.py``).

1. ``verify_checkpoint(path)`` strictly converts an ``X3D_L.pyth``
   (``convert.load_x3d_pretrained``), runs the port's X3D block by block
   (stem, stages 1-4, then the Kinetics head) in fp32 eval mode on a
   canonical seeded probe, and reports each block's activation statistics.
   On the card every stride-1 block runs as the fused CUDA kernel.
2. With ``trace`` (an npz recorded by ``tools/record_torch_trace.py`` from
   an independent torch forward of the same file) it compares every block's
   activations with the recording and gives a pass/fail verdict.

CLI: ``python -m change3d_tpu_torch.cli verify-checkpoint --pretrained
X3D_L.pyth [--trace ref_acts.npz] [--report report.json] [--device cpu]``,
exit 1 when the comparison fails.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from change3d_tpu_torch.device import resolve_device

# fp32 convolutions of two frameworks differ by reduction order only; the
# deepest tap (25-block stage 3) accumulates to about 1e-4 relative.
DEFAULT_RTOL = 1e-3
DEFAULT_ATOL = 1e-4

BLOCK_NAMES = ("block0_stem", "block1_stage1", "block2_stage2", "block3_stage3", "block4_stage4")


def fixed_probe_input(t: int = 3, h: int = 64, w: int = 64, seed: int = 0) -> np.ndarray:
    """The canonical probe: torch-layout [1, 3, T, H, W] float32 from
    RandomState(seed), as the trace recorder draws it."""
    return np.random.RandomState(seed).randn(1, 3, t, h, w).astype(np.float32)


def capture_block_activations(backbone: Mapping[str, torch.Tensor], cfg,
                              x_ncdhw: np.ndarray, device="cuda") -> Dict[str, np.ndarray]:
    """Eval-mode per-block forward of the port's X3D with its Kinetics head
    (``X3D(cfg, head=True)``) holding the converted ``backbone`` state_dict,
    on ``device``; activations in torch's NCDHW layout, plus the head's
    ``head_logits``. The head's widths are the checkpoint's."""
    from change3d_tpu_torch.models.x3d import X3D

    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, head_dim_out=backbone["head.post_conv"].shape[1],
                              num_classes=backbone["head.proj_b"].shape[0])
    model = X3D(cfg, head=True)
    model.load_state_dict(backbone)
    model = model.to(dev).eval()
    acts = {}
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(x_ncdhw.transpose(0, 2, 3, 4, 1))).to(dev)
        for i, name in enumerate(BLOCK_NAMES):
            x = model.run_block(i, x)
            acts[name] = x.permute(0, 4, 1, 2, 3).cpu().numpy()
        acts["head_logits"] = model.head(x).cpu().numpy()
    return acts


def verify_checkpoint(pretrained: str, trace: Optional[str] = None, *, t: int = 3, h: int = 64,
                      w: int = 64, seed: int = 0, rtol: float = DEFAULT_RTOL,
                      atol: float = DEFAULT_ATOL, device="cuda") -> Dict:
    """Strictly convert ``pretrained`` and build the parity report:

      {"strict_load": true, "checkpoint", "n_params", "probe": {...},
       "blocks": {name: {"shape", "mean", "std", ["max_abs_err", "rel_err",
                         "pass"]}}, "trace": path or null, "all_pass": bool or null,
       "device"}
    """
    from change3d_tpu_torch.checkpoint.convert import load_x3d_pretrained
    from change3d_tpu_torch.models.x3d import x3d_l_config

    cfg = x3d_l_config()
    backbone = load_x3d_pretrained(pretrained, cfg)  # strict: raises on any mismatch
    dev = resolve_device(device)
    report: Dict = {
        "strict_load": True,
        "checkpoint": pretrained,
        "n_params": int(sum(v.numel() for k, v in backbone.items()
                            if not k.endswith((".mean", ".var")))),
        "probe": {"t": t, "h": h, "w": w, "seed": seed},
        "trace": trace,
        "blocks": {},
        "all_pass": None,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    ref = None
    if trace is not None:
        ref = dict(np.load(trace))
        probe = json.loads(str(ref.pop("probe_json")))
        if probe != report["probe"]:
            raise ValueError(f"trace was recorded with probe {probe}, harness is using "
                             f"{report['probe']}: pass matching --frames/--height/--width/--seed")
    acts = capture_block_activations(backbone, cfg, fixed_probe_input(t, h, w, seed), dev)
    all_pass = True
    for name, a in acts.items():
        entry = {"shape": list(a.shape), "mean": float(a.mean()), "std": float(a.std())}
        if ref is not None:
            if name not in ref:
                raise ValueError(f"trace is missing array {name!r}")
            r = np.asarray(ref[name], np.float32)
            if r.shape != a.shape:
                raise ValueError(f"{name}: trace shape {r.shape} != ours {a.shape}")
            err = np.abs(a - r)
            entry["max_abs_err"] = float(err.max())
            entry["rel_err"] = float((err / np.maximum(np.abs(r), 1e-6)).max())
            entry["pass"] = bool(np.allclose(a, r, rtol=rtol, atol=atol))
            all_pass &= entry["pass"]
        report["blocks"][name] = entry
    if ref is not None:
        report["all_pass"] = bool(all_pass)
    return report


def format_report(report: Dict) -> str:
    lines = [
        f"checkpoint: {report['checkpoint']}",
        f"strict conversion: {'OK' if report['strict_load'] else 'FAILED'} "
        f"({report['n_params']:,} params)",
        f"probe: {report['probe']} on {report['device']}",
    ]
    for name, e in report["blocks"].items():
        row = f"  {name:<16} {str(e['shape']):<24} mean {e['mean']:+.4f} std {e['std']:.4f}"
        if "pass" in e:
            row += (f"  max_abs {e['max_abs_err']:.3e} rel {e['rel_err']:.3e} "
                    f"{'PASS' if e['pass'] else 'FAIL'}")
        lines.append(row)
    if report["all_pass"] is not None:
        lines.append(f"parity vs trace: {'PASS' if report['all_pass'] else 'FAIL'}")
    else:
        lines.append("no trace given: record one with tools/record_torch_trace.py on any machine "
                     "with torch and the checkpoint, then re-run with --trace")
    return "\n".join(lines)
