#!/usr/bin/env python3
"""Device-time breakdown of change3d_tpu_torch's serving forward or train
step of a task on one NVIDIA GPU (torch.profiler with CUDA activity).

    python3 tools/profile_torch_bcd.py [--task bcd] [--batch 8] [--iters 5] [--seed 0] [--plain]
    python3 tools/profile_torch_bcd.py --train [--task bcd] [--batch 16] [--iters 5]
    python3 tools/profile_torch_bcd.py --task cc [--beam 1] [--batch 8] [--iters 5]

Builds the full-width X3D-L Change3D of --task (bcd, scd with 6 classes, bda
with 5, cc with a 500-word caption decoder) from --seed; --train's default
batch is the CLI's (16, 8, 12, 32). By default it warms
``Predictor.predict_u8_device`` up on random uint8 256^2 pairs already on the
card, then profiles --iters forwards; --plain profiles the model with
fused_inference=False. For cc a forward is ``CaptionPredictor.encode`` (bf16,
the fused blocks) then ``decode`` (KV-cached beam search with --beam beams),
with a synchronisation between the two so that each phase's device work
lies inside its host window; the busy share of each phase is printed beside
the window's. With --train it warms up and then profiles --iters train
steps (``train.engine.train_step``: forward in train mode, backward, Adam;
bf16, or fp32 for cc as its CLI trains) on one synthetic 256^2 batch
already on the card.

Prints the device time per forward (or step) by kernel name and by kernel
group, the share of the fused-block kernels, the device's busy share of the
profiled window (the union of kernel intervals over the span from the first
profiled event to the last kernel's end), and the card's name and power
limit; writes the same to
chiprun_out/profile_torch_bcd[_scd|_bda|_cc[_beamK]][_plain|_train].json.
Exits non-zero when there is no card or the trace holds no device time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

# Names of the fused-block kernels in csrc/fused_block.cu (bf16 and fp32).
FUSED_KERNELS = ("fused_block_bf16_kernel", "fused_block_f32_kernel")
# Kernel groups by name, first match wins.
GROUPS = (
    ("fused blocks (csrc/fused_block.cu)", ("fused_block",)),
    ("cuDNN conv weight gradients", ("wgrad",)),
    ("cuDNN conv data gradients", ("dgrad",)),
    ("cuDNN layout conversions", ("nhwcToNchw", "nchwToNhwc")),
    ("cuDNN generic convs", ("implicit_convolveNd",)),
    ("GEMMs and tensor-core convs", ("xmma", "cutlass", "nvjet", "gemm", "sm90")),
    ("other convs", ("conv",)),
    ("reductions", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "Elementwise")),
    ("copies and fills", ("Memcpy", "Memset", "copy", "fill")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="bcd", choices=["bcd", "scd", "bda", "cc"])
    ap.add_argument("--batch", type=int, default=None,
                    help="8 (forward) or the CLI's train batch (--train)")
    ap.add_argument("--beam", type=int, default=1, help="beams of the cc decode")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plain", action="store_true", help="fused_inference=False")
    ap.add_argument("--train", action="store_true", help="profile bf16 train steps")
    args = ap.parse_args(argv)
    args.batch = args.batch or ({"bcd": 16, "scd": 8, "bda": 12, "cc": 32}[args.task]
                                if args.train else 8)
    if not torch.cuda.is_available():
        print("profile_torch_bcd: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from change3d_tpu_torch.device import resolve_device
    from change3d_tpu_torch.inference import CaptionPredictor, Predictor
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import x3d_l_config
    from change3d_tpu_torch.train.engine import train_step
    from change3d_tpu_torch.train.optim import torch_adam

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[torch.cuda.current_device()]
    cfg = x3d_l_config(fused_inference=not args.plain)
    num_classes = {"bcd": 1, "scd": 6, "bda": 5, "cc": 1}[args.task]
    vocab = 500 if args.task == "cc" else 0
    model = Change3D(Task(args.task), num_classes=num_classes, backbone_cfg=cfg, device=dev,
                     seed=args.seed, vocab_size=vocab)
    rs = np.random.RandomState(args.seed)
    phases = ()
    if args.task == "cc" and args.train:
        opt = torch_adam(model.parameters(), weight_decay=1e-5, grad_clip_value=5.0)
        batch = {k: torch.from_numpy(rs.randn(args.batch, 256, 256, 3).astype(np.float32)).to(dev)
                 for k in ("pre", "post")}
        batch["caption"] = torch.from_numpy(rs.randint(4, vocab, (args.batch, 52))).to(dev)
        batch["length"] = torch.from_numpy(rs.randint(10, 23, args.batch)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        run = lambda: train_step(model, opt, lambda _: 1e-4, batch, 0, generator=gen)
    elif args.task == "cc":
        words = {"<pad>": 0, "<unk>": 1, "<start>": 2, "<end>": 3}
        words.update({f"w{i}": i for i in range(4, vocab)})
        pred = CaptionPredictor(model, words, beam_size=args.beam, compute_dtype=torch.bfloat16,
                                device=dev)
        pre, post = (torch.from_numpy(rs.randint(0, 256, (args.batch, 256, 256, 3))
                                      .astype(np.uint8)).to(dev) for _ in range(2))
        phases = ("cc_encoder", "cc_decode")

        def run():
            with torch.profiler.record_function("cc_encoder"):
                memory = pred.encode(pre, post)
                torch.cuda.synchronize()
            with torch.profiler.record_function("cc_decode"):
                pred.decode(memory)
                torch.cuda.synchronize()
    elif args.train:
        opt = torch_adam(model.parameters(), weight_decay=1e-4)
        batch = {k: torch.from_numpy(rs.randn(args.batch, 256, 256, 3).astype(np.float32)).to(dev)
                 for k in ("pre", "post")}
        shape = (args.batch, 256, 256)
        change = (rs.rand(*shape, 1) > 0.8).astype(np.int32)
        label = {"bcd": lambda: change,
                 "scd": lambda: np.concatenate([rs.randint(0, 6, shape + (2,)), change], -1),
                 "bda": lambda: np.concatenate([change, rs.randint(0, 5, shape + (1,))], -1)}
        batch["label"] = torch.from_numpy(label[args.task]().astype(np.int32)).to(dev)
        run = lambda: train_step(model, opt, lambda _: 2e-4, batch, 0,
                                 compute_dtype=torch.bfloat16)
    else:
        pred = Predictor(model, compute_dtype=torch.bfloat16, device=dev)
        pre, post = (torch.from_numpy(rs.randint(0, 256, (args.batch, 256, 256, 3))
                                      .astype(np.uint8)).to(dev) for _ in range(2))
        run = lambda: pred.predict_u8_device(pre, post)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.iters):
            run()
        torch.cuda.synchronize()

    events = prof.events()
    # Device events, less the device-side copies of the phase annotations.
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in phases]
    if not kernels:
        raise RuntimeError("the trace holds no device events")
    by_name = {}
    for e in kernels:
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.elapsed_us()
        row[1] += 1
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in kernels)
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    device_ms = sum(v[0] for v in by_name.values()) / args.iters / 1e3
    fused_ms = sum(v[0] for k, v in by_name.items()
                   if any(n in k for n in FUSED_KERNELS)) / args.iters / 1e3
    rows = sorted(({"name": k, "ms_per_forward": v[0] / args.iters / 1e3,
                    "launches_per_forward": v[1] / args.iters} for k, v in by_name.items()),
                  key=lambda r: -r["ms_per_forward"])
    # Summed kernel time can exceed the window where kernels overlap (cuDNN
    # runs some convolution gradients on several streams), so each group
    # also gets the union of its kernels' intervals: the time it occupies.
    groups, spans = {}, {}
    for r in rows:
        g = groups.setdefault(group_of(r["name"]), {"ms_per_forward": 0.0, "launches": 0.0})
        g["ms_per_forward"] += r["ms_per_forward"]
        g["launches"] += r["launches_per_forward"]
    for e in kernels:
        spans.setdefault(group_of(e.name), []).append((e.time_range.start, e.time_range.end))
    for g, v in groups.items():
        v["busy_ms_per_forward"] = busy_us(spans[g]) / args.iters / 1e3
    # Per phase (cc): the union of the kernels that start inside the phase's
    # host windows, over the windows' length.
    phase_share = {}
    for name in phases:
        windows = [(e.time_range.start, e.time_range.end) for e in events
                   if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]
        inside = [(e.time_range.start, e.time_range.end) for e in kernels
                  if any(s <= e.time_range.start <= t for s, t in windows)]
        span = sum(t - s for s, t in windows)
        phase_share[name] = {"window_ms_per_forward": span / args.iters / 1e3,
                             "busy_ms_per_forward": busy_us(inside) / args.iters / 1e3,
                             "busy_share": busy_us(inside) / span}
    summary = {"card": card, "task": args.task, "mode": "train" if args.train else "forward",
               "beam": args.beam if args.task == "cc" else None, "phases": phase_share,
               "fused_inference": not args.plain, "batch": args.batch, "iters": args.iters,
               "window_ms_per_forward": (end - start) / args.iters / 1e3,
               "kernel_ms_per_forward": device_ms, "fused_block_ms_per_forward": fused_ms,
               "busy_share": busy / (end - start),
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms_per_forward"])),
               "kernels": rows}
    for r in rows[:25]:
        print(f"{r['ms_per_forward']:9.3f} ms {r['launches_per_forward']:6.1f}x  {r['name'][:110]}")
    for g, v in summary["groups"].items():
        print(f"{v['ms_per_forward']:9.3f} ms summed, {v['busy_ms_per_forward']:9.3f} ms busy "
              f"{v['launches']:8.1f}x  [{g}]")
    print(json.dumps({k: v for k, v in summary.items() if k not in ("kernels", "groups")}))
    os.makedirs("chiprun_out", exist_ok=True)
    task = "" if args.task == "bcd" else f"_{args.task}"
    beam = f"_beam{args.beam}" if args.task == "cc" and not args.train else ""
    out = (f"profile_torch_bcd{task}{beam}{'_plain' if args.plain else ''}"
           f"{'_train' if args.train else ''}.json")
    with open(os.path.join("chiprun_out", out), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
