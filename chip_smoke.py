#!/usr/bin/env python3
"""Smoke run of change3d_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py [--batch 8] [--batches 3] [--seed 0]
                          [--multi-gpu-only | --int8-only | --data-only |
                           --classify-only | --kinetics-only |
                           --depthwise-only]

Run from the repository root. Phases (any failure exits non-zero and prints
no result line):

1. build: compile every native library from csrc/ (one nvcc per CUDA
   source and c++ for the host METEOR scorer meteor.cpp, all started
   together) and print the card's name and power limit;
2. kernels: hold each kernel against its plain PyTorch version on the card
   at the four X3D-L stage shapes at 256^2 on the clips of the three tasks
   (T=3 BCD and CC, T=4 BDA, T=5 SCD), with and without SE, at B=2, B=3 and
   --batch, over KERNEL_SEEDS seeds, and at CC's evaluation batch (32) on
   T=3, in fp32 (TF32 off; |d| <= 1e-4 * (1 + |ref|)) and bf16 (|d| <= 2
   bf16 ulps of max(|ref|, 1)); prints the worst |d| per T and the share of
   the limit it uses; then the depthwise conv kernel (ops/depthwise_conv.py)
   against its plain version at the stem's, the strided block 0s' and the
   stride-1 blocks' shapes (DEPTHWISE) on each clip, at B=2 and --batch,
   and at X3D-M's 16-frame shapes, in fp32 (|d| <= 1e-5 * (1 + |ref|)) and
   bf16, and a non-contiguous input refused;
3. forward, for BCD, SCD (6 classes) and BDA (5 classes) in turns: build the
   task's full-width X3D-L Change3D from a seed, run Predictor.predict_u8 on
   --batches batches of random uint8 256^2 pairs with every launch count
   reset just before, and require 37 fused_block_fwd and 18
   fused_block_se_sums launches per forward; then hold every head's fp32
   probabilities (sigmoid masks, softmax class maps) of the fused model
   against fused_inference=False (1e-3) on a whole batch and report the
   bf16 agreement of each mask and class map; then CC (stages 1-4, a
   500-word decoder): CaptionPredictor.caption_u8 at beam 1 and 3, 51
   fused_block_fwd and 25 fused_block_se_sums launches per forward, the
   fp32 memory fused vs plain (1e-3 of its max), equal fp32 tokens fused vs
   plain at beam 1 and 3, and the bf16 tokens' agreement with the plain
   bf16 model; then the depthwise kernel's launches in one forward at batch
   16 of each path (DEPTHWISE_PER_FORWARD: 4 per BCD, SCD and BDA
   predict_u8, 41 per int8 BCD one, 5 per CC caption_u8 and per X3D-M
   classify forward) and a profiled BCD predict_u8 whose only kernels of
   cuDNN's per-channel conv engines (implicit_convolveNd, xmma_fprop ...
   f32f32) are those of the dense stem conv_s, which stays on cuDNN;
4. repros: hold the two repro kernels (ops/repros.py: dot_1d within two
   bf16 ulps, manual_dma exactly) against their plain versions at the
   repros' shapes over KERNEL_SEEDS seeds and at REPRO_DOT_SHAPES and
   REPRO_DMA_SHAPES, with REPRO_RERUNS bit-identical reruns of every
   dot_1d check, then drive their entry point
   (``python -m change3d_tpu_torch.ops.repros``, in process) with their
   launch counts reset just before, and require a launch of each;
5. times: bf16 pairs/s of each task's predict_u8 at --batch, with the
   fused blocks and with fused_inference=False in turns, and device ms per
   forward; each fused kernel's time per stage shape and T (3, 4, 5) from
   CUDA events (on operands first held against the plain version), its
   launches per forward, its bound, its blocks per SM and its plain
   version's time; each repro kernel's time, plain time and library
   time (torch.mul(x, 2.0) for manual_dma) on the device timeline
   (torch.profiler), their in-call ratios, the CUDA-event times beside
   them, its bound, and nvidia-smi's clock and power before and after;
   CC caption_u8 captions/s at beam 1 and 3, the encoder's and the decode's
   CUDA-event ms, the decode's device-busy ms, steps and host ms per step;
   the fused kernels also at B=32 on T=3 with their launches per CC forward;
   the depthwise kernel's ms per launch at every DEPTHWISE shape at batch
   16 on each clip and at X3D-M's at batch 8, beside its plan, bytes bound,
   plain version's ms, cuDNN's F.conv3d(groups=C) ms on [B, C, T, H, W]
   (library_ms) and with the two relayouts around it (relayout_library_ms),
   and its sum over a fused, an int8 (unfused) and an X3D-M forward;
6. train parity, for BCD, SCD and BDA: one fp32 train step (TF32 off) of a
   reduced-depth model at 64², batch 2, on the card against the same step
   on the CPU (loss 1e-4 relative, each gradient tensor 1e-2 relative in the
   2-norm, BN running stats 1e-4; the step's metrics' differences reported),
   and CC's (dropout 0; loss 1e-4, top1 equal, gradients 1e-2);
7. overfit: the full-width X3D-L BCD model, bf16, batch 16, 256², 10 Adam
   steps at lr 2e-4 on one synthetic batch whose label is a function of the
   pair; every loss finite and the last below the first;
8. train times on that model, then on full-width SCD (batch 8) and BDA
   (batch 12) models: samples/s by host clock over 10 steps after 3 warm-up
   steps, device ms per step by CUDA events, peak memory, and validation
   pairs/s through eval_step; then CC at the CLI defaults (fp32, batch 32,
   no remat) and in bf16 at batch 32, with evaluation captions/s at batch
   32;
9. train loops: ``python -m change3d_tpu_torch.cli bcd``, ``cli scd`` and
   ``cli bda`` in process on synthetic LEVIR-CD, SECOND and xBD layouts
   (two train batches and one test batch at the task's default batch, 16, 8
   and 12, at 256², written with data/png.py; xBD with its
   'disaster_target' label names) for 2 epochs in bf16, with the fused
   launch counts reset just before each: 37 + 18 launches for each of its 2
   validation forwards (epoch 1 and the best-model re-evaluation), best/,
   the sidecar and the epoch-1 log written; then ``--resume`` restores
   step 4; then ``cli cc`` (fp32, batch 32) on a synthetic 256² LEVIR-CC
   layout (HDF5 written by data/hdf5.py, read by ``CaptionDataset``
   through it; ``--loader grain``: worker processes) for 2 epochs with beam
   evaluation after each, METEOR scored by the native library: 3 x (51 +
   25) launches, the BLEU-4 gate, ``--resume`` at step 4;
10. deploy, in process at full width and 256²: a reference-named BCD
   ``Trainer`` file made from a seeded port model (``reference_trainer_sd``,
   the converter's key map inverted) through ``cli convert-reference``
   (the weights come back exactly) and ``cli predict`` on a synthetic
   LEVIR layout (2 x (37 + 18) launches, PNGs byte-equal to a direct
   Predictor); a Kinetics X3D file through ``cli verify-checkpoint`` (exit
   0, the report printed); ``cli eval`` of phase 9's ``cli bcd`` run (equal
   to its final report); ``cli predict --tiled`` on a 1024² scene (37 + 18
   launches per tile batch, byte-equal to a direct TiledPredictor, scene
   ms); then ``PredictService`` + ``make_server`` on 127.0.0.1 in a thread,
   BCD at batch 16 with buckets 4/8/16, warmed up: JSON, raw and bulk
   requests through ``PredictClient`` byte-equal to ``predict_u8`` on the
   same (padded) batch, 37 + 18 launches per dispatched batch, and a closed
   loop of LOAD_CLIENTS x LOAD_REQUESTS raw requests (requests/s, p50/p99
   from /metrics); and a CC server at batch 8, beam 1 (51 + 25 launches per
   batch, captions equal to caption_u8's);
11. export, on phase 9's runs (``phase_export``), four ``cli export``
   processes at once: the ``cli bcd`` run on the card with a symbolic batch
   and on the CPU pinned to batch 8, the ``cli cc`` run at beam 1 on the CPU
   and 3 on the card. ``ArtifactPredictor``:
   masks equal to the live ``Predictor.predict`` on the same float batch at
   batch 4, 8 and 16 from the one artifact, probabilities within the bf16
   limit, exactly 37 + 18 fused launches per artifact forward; the
   CPU-exported artifact moved to the card names only the card in its
   graph, launches the same and is refused at --batch_size 16;
   ``CaptionArtifactPredictor`` captions equal to ``CaptionPredictor``'s at
   beam 1 and 3 with 51 + 25 launches per call; the symbolic BCD artifact
   served in process (masks equal to ``ArtifactPredictor.predict`` on the
   same batch, 37 + 18 launches per batch, a closed loop of
   ARTIFACT_CLIENTS x ARTIFACT_REQUESTS raw requests for requests/s and
   p50 / p99); artifact vs live float-path pairs/s at batch 8. While the
   exports run, ``cli bcd --profile_dir`` trains on a 64² layout at batch 1
   until its window (steps 10-14) closes, and its trace must hold CUDA
   kernel events. Export seconds and artifact bytes are printed; details
   under the ``export`` key;
12. multi-GPU (``phase_multi_gpu``): ``cli bcd`` and then ``cli cc`` on
   phase 9's layouts as N = torch.cuda.device_count() processes, one per
   card, with ``--coordinator_address 127.0.0.1:PORT --num_processes N
   --process_id i`` (this script's ``--rank-worker``, each process's fused
   launch counts set to 0 just before its run and read just after): NCCL
   up at world N on card i, 2 x (37 + 18) launches per BCD process and 3 x
   (51 + 25) per CC process, every process's report equal, then
   ``--resume`` at step 4 (one more evaluation forward each); then a
   ``shard=True`` Predictor over every card on SHARD_PAIRS_PER_CARD x N
   pairs against one card's on the same slices of SHARD_PAIRS_PER_CARD:
   masks equal, (37 + 18) launches per card. Details under the ``multi_gpu`` key;
13. int8 and remat (``phase_quant``), at full width, 256², bf16: for BCD,
   SCD and BDA the int8 model (``quantized_eval``) with the fused model's
   weights, dynamic and static (``calibrate_quant_scales`` on 8 seeded
   batches of 4): ``predict_u8`` at --batch with the counts set to 0 just
   before, exactly 0 + 0 fused launches and 80 int8 products
   (``quant.int8_matmul``) per forward, the decisions of its bf16 maps
   equal to the fused bf16 model's on >= 99.5% of the confident pixels,
   and every product's shape held exactly against the fp64 product of the
   same int8 operands (the padded K = 54 and 108 included); CC's
   ``caption_u8`` with a dynamic int8 encoder at beam 1 (110 products);
   ``cli predict --quantized --quant_mode static`` on phase 9's BCD run,
   PNGs byte-equal to a direct static Predictor, and the ``cli export
   --quantized --quant_mode static`` artifact (exported in a subprocess
   meanwhile) with 80 ``aten._int_mm`` nodes and masks equal to that
   Predictor's; then pairs/s and device ms of the fused, plain (unfused
   bf16), dynamic and static forwards in turns, the int8 GEMM's share of a
   forward (profiler), and the 80 int8 pointwise sites' ms split into the
   product and the quantise / rescale passes beside bf16 matmuls;
   then one BCD train step at batch 16 with and without remat from one
   state: fp32 parity (loss and gradients 1e-5 relative in the 2-norm, BN
   running stats 1e-6) and bf16 ms per step and peak memory, the remat
   peak lower. Details under the ``quant`` key;
14. data (``phase_data``): the committed h5py-written fixture
   tests/torch_fixtures/levircc_tiny.hdf5 read by data/hdf5.py equal to what
   its seed regenerates; seconds to the first batch, and samples/s over a
   window of 10 waves of the workers' prefetch (10 x workers x 2 batches),
   of the threaded loader and of ``--loader grain`` at 2, 4 and 8 workers
   on a synthetic LEVIR-CD PNG layout (BCD train transforms, batch 16) and
   on a LEVIR-CC HDF5 layout (batch 32); native and Python METEOR
   seconds on a 1929-image, 5-reference split of seeded ids, the scores
   equal within 1e-12. Details under the ``data`` key;
15. classify (``phase_classify``, run right after phase 5): X3D-M (16 x
   224²), X3D-S (13 x 160²) and X3D-XS (4 x 160²) as Kinetics classifiers
   (``x3d_classifier``, seeded weights) at batch 8 in bf16: 22
   fused_block_fwd and 11 fused_block_se_sums launches per forward (the
   counts set to 0 just before), finite [8, 400] logits; both kernels held
   against their plain versions on the operands the bf16 and the fp32
   forwards give them, at every block shape (stages 3 and 4 of the 16- and
   13-frame clips take T-tiles); the fp32 logits fused vs
   fused_inference=False within 1e-3 with equal top-1; clips/s and device
   ms per forward, fused and plain in turns; each kernel's time per shape
   with its T-tile, bound and plain time. Details under the ``classify``
   key;
16. kinetics (``phase_kinetics``, run right after phase 15): X3D-L as the
   Kinetics-400 classifier of the benchmark's x3dl-classify-v30 cell,
   ``ClipClassifier(x3d_classifier("l"))`` with seeded weights on one
   video's 30 views (B = 30 uint8 16 x 312² clips) in bf16: 51
   fused_block_fwd, 25 fused_block_se_sums and 5 depthwise_conv3d
   launches in one classify_u8 call (the counts set to 0 just before),
   finite [30, 400] logits; both fused kernels held against their plain
   versions on the operands the bf16 and the fp32 forwards give them at
   the four stage shapes (ragged 4 x 4 tiles at 78, 39 and 10; stages 3
   and 4 in T-tiles of 8 and 3), the depthwise kernel at the stem's and
   the four strided conv_b's shapes (39 -> 20 among them), all at B = 30;
   the fp32 logits fused vs fused_inference=False within 1e-3 of the
   largest, with equal top-1; classify_u8 clips/s, the forward's and the
   upload's ms on the device; each kernel's time per shape at B = 30, and
   the three kernels summed per forward (``kernels x3d_l_k400`` line).
   Details under the ``kinetics`` key.

``--int8-only`` builds the kernels, trains phase 9's ``cli bcd`` run and runs
phase 13 on it, details beside ``--out`` as ``chip_smoke_int8.json``.
``--multi-gpu-only`` builds the kernels and runs phase 12 alone on freshly
written layouts (the proof on several cards), its details beside ``--out``
as ``chip_smoke_multi_gpu.json``. ``--data-only`` builds them and runs
phase 14 and phase 9's ``cli cc``, details as ``chip_smoke_data.json``.
``--classify-only`` builds them and runs phase 15 alone, details as
``chip_smoke_classify.json``. ``--kinetics-only`` builds them and runs
phase 16 alone, details as ``chip_smoke_kinetics.json``; its last lines are
the per-forward kernels JSON, the card line and the ok line.
``--depthwise-only`` builds them and runs the
depthwise kernel's part of phases 2, 3 and 5, details as
``chip_smoke_depthwise.json``.

The last lines are the kernels JSON, the card line from nvidia-smi, and
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# NVIDIA H100 SXM peaks (data sheet, dense): HBM bytes/s, bf16 tensor-core
# flop/s, fp32 CUDA-core flop/s.
HBM_BYTES_S = 3.35e12
BF16_TC_FLOPS = 989e12
FP32_FLOPS = 67e12

# (name, H=W at 256^2 input, C, Ci, SE reduced dim, fwd launches per
# forward, se_sums launches per forward; the same for BCD, SCD and BDA)
STAGES = (
    ("stage1", 128, 24, 54, 8, 4, 2),
    ("stage2", 64, 48, 108, 8, 9, 4),
    ("stage3", 32, 96, 216, 16, 24, 12),
    ("stage4", 16, 192, 432, 32, 0, 0),  # CC only: not on the detection paths
)
# Launches per CC forward (T = 3, stages 1-4): (fused_block_fwd, fused_block_se_sums).
CC_LAUNCHES = {"stage1": (4, 2), "stage2": (9, 4), "stage3": (24, 12), "stage4": (14, 7)}
CC_PER_FORWARD = {"fused_block_fwd": 51, "fused_block_se_sums": 25}
# CC: the vocabulary of a LEVIR-CC word map at minimum word frequency 5
# (about 500 entries), captions padded to 52 tokens, the CLI's batch (32).
CC_VOCAB, CC_LEN, CC_BATCH = 500, 52, 32
TASKS = ("bcd", "scd", "bda")
# Clip length (2 + perception frames), classes of the class heads, default
# train batch (the CLI's).
CLIP_T = {"bcd": 3, "scd": 5, "bda": 4}
NUM_CLASSES = {"bcd": 1, "scd": 6, "bda": 5}
TRAIN_BATCH = {"bcd": 16, "scd": 8, "bda": 12}
CLIPS = sorted(set(CLIP_T.values()))
# Phase 2 draws operands from this many seeds, from --seed on: the bf16
# limit's margin is read over all of them.
KERNEL_SEEDS = 3
SOURCE = "change3d_tpu_torch/csrc/fused_block.cu"
PALLAS = "change3d_tpu/ops/pallas/fused_block.py"
DW_SOURCE = "change3d_tpu_torch/csrc/depthwise_conv3d.cu"
REPRO_SOURCE = "change3d_tpu_torch/csrc/repros.cu"
REPRO_PALLAS = "tests/manual_pallas_repros.py"
# Phase 4's shapes beyond the repros' own. dot_1d (R, C, N): R ragged over
# the cluster's 8 ranks, R < 8. manual_dma (N, R, C): one chunk per slab, a
# ragged last chunk, a 1 MB slab, four and two chunks per block (the double
# buffer, the second ragged).
REPRO_DOT_SHAPES = ((1000, 40, 40), (5, 128, 128))
REPRO_DMA_SHAPES = ((3, 16, 8), (5, 100, 36), (1, 512, 512), (16, 512, 512), (50, 300, 100))
REPRO_RERUNS = 5
# Phase 15: the Kinetics classifiers (name, frames, side) at their published
# clips, batch 8, and the fused launches of one forward: stages of depths
# 3, 5, 11, 7 run 2 + 4 + 10 + 6 fused blocks, 1 + 2 + 5 + 3 of them SE.
CLASSIFY = (("x3d_m", 16, 224), ("x3d_s", 13, 160), ("x3d_xs", 4, 160))
CLASSIFY_BATCH = 8
CLASSIFY_PER_FORWARD = {"fused_block_fwd": 22, "fused_block_se_sums": 11}
STAGE_OF_WIDTH = {24: "stage1", 48: "stage2", 96: "stage3", 192: "stage4"}
# The depthwise convs outside the fused blocks (ops/depthwise_conv.py), at
# 256² on every clip: (name, H=W of the input, C, kernel, stride, padding,
# launches per detection forward, per CC forward, per unfused detection
# forward (int8 or fused_inference=False), per unfused CC forward). X3D-M's
# (16 x 224², stem stride (1, 2, 2)): its stem, four block 0s and stride-1
# blocks, (name, T, H=W, C, kernel, stride, padding, launches per classify
# forward, per unfused one). X3D-L's stages are 5, 10, 25, 15 blocks deep,
# X3D-M's 3, 5, 11, 7.
DW_S2 = ((3, 3, 3), (1, 2, 2), (1, 1, 1))
DW_S1 = ((3, 3, 3), (1, 1, 1), (1, 1, 1))
DEPTHWISE = (
    ("stem", 256, 24, (5, 1, 1), (1, 1, 1), (2, 0, 0), 1, 1, 1, 1),
    ("stage1", 256, 54, *DW_S2, 1, 1, 1, 1),
    ("stage2", 128, 108, *DW_S2, 1, 1, 1, 1),
    ("stage3", 64, 216, *DW_S2, 1, 1, 1, 1),
    ("stage4", 32, 432, *DW_S2, 0, 1, 0, 1),  # CC only
    ("stage1_s1", 128, 54, *DW_S1, 0, 0, 4, 4),
    ("stage2_s1", 64, 108, *DW_S1, 0, 0, 9, 9),
    ("stage3_s1", 32, 216, *DW_S1, 0, 0, 24, 24),
    ("stage4_s1", 16, 432, *DW_S1, 0, 0, 0, 14),  # CC only
)
DEPTHWISE_X3DM = (
    ("x3dm_stem", 16, 112, 24, (5, 1, 1), (1, 1, 1), (2, 0, 0), 1, 1),
    ("x3dm_stage1", 16, 112, 54, *DW_S2, 1, 1),
    ("x3dm_stage2", 16, 56, 108, *DW_S2, 1, 1),
    ("x3dm_stage3", 16, 28, 216, *DW_S2, 1, 1),
    ("x3dm_stage4", 16, 14, 432, *DW_S2, 1, 1),
    ("x3dm_stage1_s1", 16, 56, 54, *DW_S1, 0, 2),
    ("x3dm_stage2_s1", 16, 28, 108, *DW_S1, 0, 4),
    ("x3dm_stage3_s1", 16, 14, 216, *DW_S1, 0, 10),
    ("x3dm_stage4_s1", 16, 7, 432, *DW_S1, 0, 6),
)
# Phase 16: X3D-L as the benchmark's Kinetics-400 classifier (one video's
# 30 views of 16 x 312², stem stride (1, 2, 2)): stages of depths 5, 10, 25,
# 15 run 4 + 9 + 24 + 14 fused blocks, 2 + 4 + 12 + 7 of them SE; the stem's
# conv_t and the four strided conv_b's run on the depthwise kernel, (name,
# T, H=W of the input, C, kernel, stride, padding).
KINETICS = ("x3d_l_k400", 30, 16, 312)
KINETICS_PER_FORWARD = {"fused_block_fwd": 51, "fused_block_se_sums": 25, "depthwise_conv3d": 5}
DEPTHWISE_X3DL = (
    ("x3dl_stem", 16, 156, 24, (5, 1, 1), (1, 1, 1), (2, 0, 0)),
    ("x3dl_stage1", 16, 156, 54, *DW_S2),
    ("x3dl_stage2", 16, 78, 108, *DW_S2),
    ("x3dl_stage3", 16, 39, 216, *DW_S2),
    ("x3dl_stage4", 16, 20, 432, *DW_S2),
)
# Launches of one forward: the stem and each block 0 (the other blocks are
# fused); an int8 detection forward fuses none: the stem and all 40 blocks.
DEPTHWISE_PER_FORWARD = {"bcd": 4, "scd": 4, "bda": 4, "int8_bcd": 41, "cc": 5, "x3d_m": 5}
# The benchmark's batch (and cli predict's), at which the rows are timed.
DW_BATCH = 16


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else "unknown"


def operands(rs, b, t, hw, c, ci, cr, dtype, dev, has_se):
    """Block operands at model scale: x >= 0 (it is a ReLU output),
    torch-default conv init, BN folds near identity."""
    u = lambda fan, *s: torch.from_numpy(rs.uniform(-1, 1, s).astype(np.float32) / math.sqrt(fan))
    n = lambda scale, base, *s: torch.from_numpy((base + scale * rs.randn(*s)).astype(np.float32))
    x = torch.from_numpy(np.abs(rs.randn(b, t, hw, hw, c)).astype(np.float32))
    ops = [x, u(c, c, ci), n(0.1, 1, ci), n(0.1, 0, ci), u(27, 3, 3, 3, ci), n(0.1, 1, ci),
           n(0.1, 0, ci), u(ci, ci, c), n(0.1, 1, c), n(0.1, 0, c)]
    ops = [o.to(dev) for o in ops]
    ops[0] = ops[0].to(dtype)
    se = (u(ci, ci, cr), n(0.1, 0, cr), u(cr, cr, ci), n(0.1, 0, ci)) if has_se else None
    return ops, None if se is None else tuple(s.to(dev) for s in se)


def within(got, ref, dtype, fp32_tol=1e-4):
    """(ok, max |d|, max |d| / limit) under the stated limit for the dtype:
    fp32_tol * (1 + |ref|) in fp32, two bf16 ulps of max(|ref|, 1) in bf16."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    if dtype == torch.float32:
        tol = fp32_tol * (1 + ref.abs())
    else:
        tol = 2 * torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1.0))) - 7)
    used = float((d / tol).max())
    return used <= 1.0 and bool(torch.isfinite(got).all()), float(d.max()), used


def event_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(b, t, hw, c, ci, itemsize, *, sums, n_tiles):
    """Least time on the card: bytes over HBM rate, 1x1-conv flops over the
    bf16 tensor-core rate, 27 depthwise taps over the fp32 rate; the largest."""
    pix = b * t * hw * hw
    front_w = c * ci * itemsize + (27 + 4) * ci * 4
    if sums:
        nbytes = pix * c * itemsize + front_w + b * n_tiles * ci * 4
        conv = 2 * pix * c * ci
    else:
        nbytes = 2 * pix * c * itemsize + front_w + ci * c * itemsize + 2 * c * 4 + b * ci * 4
        conv = 4 * pix * c * ci
    times = {"bytes": nbytes / HBM_BYTES_S, "operations": max(conv / BF16_TC_FLOPS,
                                                              2 * 27 * pix * ci / FP32_FLOPS)}
    kind = max(times, key=times.get)
    return times[kind] * 1e3, kind


def hold(worst, key, t, what, got, ref, dtype, fp32_tol=1e-4):
    """Check got against ref, keep the worst |d| and share of the limit per
    (key, T, dtype), raise past the limit."""
    ok, err, used = within(got, ref, dtype, fp32_tol)
    w = worst[key].setdefault(f"T{t}", {}).setdefault(
        str(dtype).split(".")[-1], {"max_abs_err": 0.0, "limit_used": 0.0})
    w["max_abs_err"], w["limit_used"] = max(w["max_abs_err"], err), max(w["limit_used"], used)
    if not ok:
        raise AssertionError(f"{key} {what} {dtype}: max |d| {err}, {used:.3f} of the limit")


def check_block(fb, worst, what, ops, se, dtype):
    """Both kernels against their plain versions on one block's operands."""
    t, hw = ops[0].shape[1], ops[0].shape[2]
    gate = None
    if se is not None:
        ref_sums = fb.se_sums_reference(*ops[:7])
        hold(worst, "fused_block_se_sums", t, what, fb.fused_block_se_sums(*ops[:7]).sum(1)
             / (t * hw * hw), ref_sums.sum(1) / (t * hw * hw), dtype)
        gate = fb.se_gate(ref_sums.sum(1) / (t * hw * hw), *se)
    hold(worst, "fused_block_fwd", t, what, fb.fused_block_fwd(*ops, gate),
         fb.fused_block_fwd_reference(*ops, gate), dtype)
    if se is not None:  # the wrapper's own SE path end to end
        hold(worst, "fused_block_fwd", t, what + " sums->gate->fwd",
             fb.fused_bottleneck_block(*ops, se), fb.fused_block_reference(*ops, se), dtype)


def phase_kernels(fb, dev, seeds, batch):
    worst = {"fused_block_fwd": {}, "fused_block_se_sums": {}}
    for t in CLIPS:
        for seed in seeds:
            rs = np.random.RandomState(seed)
            for name, hw, c, ci, cr, _, _ in STAGES:
                for b in sorted({2, 3, batch}):
                    for has_se in (False, True):
                        for dtype in (torch.float32, torch.bfloat16):
                            ops, se = operands(rs, b, t, hw, c, ci, cr, dtype, dev, has_se)
                            check_block(fb, worst, f"{name} T={t} B={b} se={has_se} seed={seed}",
                                        ops, se, dtype)
        print(f"kernels T={t} seeds {seeds}: "
              f"{json.dumps({k: v[f'T{t}'] for k, v in worst.items()})}", flush=True)
    # CC's evaluation batch (32) at every stage shape, stage 4 included, on T = 3.
    rs = np.random.RandomState(seeds[0] + 7)
    for name, hw, c, ci, cr, _, _ in STAGES:
        for has_se in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                ops, se = operands(rs, CC_BATCH, 3, hw, c, ci, cr, dtype, dev, has_se)
                check_block(fb, worst, f"{name} T=3 B={CC_BATCH} se={has_se}", ops, se, dtype)
    print(f"kernels T=3 B={CC_BATCH}, stages 1-4 (worst of T=3 so far): "
          f"{json.dumps({k: v['T3'] for k, v in worst.items()})}", flush=True)
    return worst


def dw_operands(rs, b, t, hw, c, ks, dtype, dev):
    """A depthwise conv's operands: x ~ N(0, 1), weights U(+-1/sqrt(taps))
    (torch's conv init)."""
    x = torch.from_numpy(rs.randn(b, t, hw, hw, c).astype(np.float32)).to(dev, dtype)
    k = rs.uniform(-1, 1, (c, 1, *ks)) / math.sqrt(math.prod(ks))
    return x, torch.from_numpy(k.astype(np.float32)).to(dev)


def phase_depthwise(dwc, dev, seeds, batch, worst):
    """Phase 2 for the depthwise kernel: against its plain version at every
    DEPTHWISE shape on each clip (CC's stage 4 on T = 3) at B = 2 and --batch
    over the seeds, and at X3D-M's shapes at B = 2, in fp32 (|d| <= 1e-5 *
    (1 + |ref|)) and bf16 (two bf16 ulps of max(|ref|, 1)); a
    non-contiguous x raises."""
    worst["depthwise_conv3d"] = {}
    cases = [(t, b, *shape[:6]) for t in CLIPS for shape in DEPTHWISE
             if shape[6] or shape[8] or t == 3 for b in sorted({2, batch})]
    for seed in seeds:
        rs = np.random.RandomState(seed + 11)
        for t, b, name, hw, c, ks, stride, pad in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x, k = dw_operands(rs, b, t, hw, c, ks, dtype, dev)
                hold(worst, "depthwise_conv3d", t, f"{name} T={t} B={b} seed={seed}",
                     dwc.depthwise_conv3d(x, k, stride=stride, padding=pad),
                     dwc.depthwise_conv3d_reference(x, k, stride, pad), dtype, fp32_tol=1e-5)
    rs = np.random.RandomState(seeds[0] + 12)
    for name, t, hw, c, ks, stride, pad, _, _ in DEPTHWISE_X3DM:
        for dtype in (torch.float32, torch.bfloat16):
            x, k = dw_operands(rs, 2, t, hw, c, ks, dtype, dev)
            hold(worst, "depthwise_conv3d", t, name, dwc.depthwise_conv3d(
                x, k, stride=stride, padding=pad), dwc.depthwise_conv3d_reference(
                x, k, stride, pad), dtype, fp32_tol=1e-5)
    x, k = dw_operands(rs, 1, 3, 8, 16, (3, 3, 3), torch.bfloat16, dev)
    try:
        dwc.depthwise_conv3d(x.transpose(2, 3), k)
    except ValueError:
        pass
    else:
        raise AssertionError("depthwise_conv3d took a non-contiguous x")
    print(f"kernels depthwise_conv3d, T={CLIPS} and 16, seeds {seeds}: "
          f"{json.dumps(worst['depthwise_conv3d'])}", flush=True)


def per_channel_conv(name: str) -> bool:
    """The cuDNN engines that ran a grouped conv3d one launch per channel
    (the dense stem conv_s runs on the first of them too)."""
    return "implicit_convolveNd" in name or ("xmma_fprop" in name and "f32f32" in name)


def device_kernels(fn):
    """The device events of one profiled call of ``fn`` (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def phase_depthwise_forwards(dwc, dev, seed, batch):
    """Phase 3 for the depthwise kernel: its launches in one bf16 forward
    of each path (the count set to 0 just before; DEPTHWISE_PER_FORWARD):
    BCD, SCD and BDA ``predict_u8``, an int8 BCD ``predict_u8``, CC's
    ``caption_u8`` (beam 1) at ``batch`` 256² pairs and an X3D-M classify
    forward on two 16 x 224² clips; then one profiled BCD ``predict_u8``,
    in which the only kernels of cuDNN's per-channel conv engines are the
    dense stem conv_s's own (the same names, launch for launch, as conv_s
    alone), its device ms and the depthwise kernel's share."""
    from change3d_tpu_torch.inference import CaptionPredictor, Predictor
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import x3d_classifier, x3d_l_config
    from change3d_tpu_torch.ops.layers import conv3d

    rs = np.random.RandomState(seed + 17)
    pairs = tuple(rs.randint(0, 256, (batch, 256, 256, 3)).astype(np.uint8) for _ in range(2))
    counts = {}

    def count(name, fn):
        fn()  # load the kernels, warm the allocator
        torch.cuda.synchronize()
        dwc.depthwise_conv3d.launches = 0
        fn()
        torch.cuda.synchronize()
        counts[name] = dwc.depthwise_conv3d.launches

    preds = {}
    for task in TASKS:
        model = Change3D(Task(task), num_classes=NUM_CLASSES[task], device=dev, seed=seed)
        preds[task] = Predictor(model, compute_dtype=torch.bfloat16, device=dev)
        count(task, lambda: preds[task].predict_u8(*pairs))
    int8 = Change3D(Task.BCD, backbone_cfg=x3d_l_config(quantized_eval=True), device=dev,
                    seed=seed)
    int8_pred = Predictor(int8, compute_dtype=torch.bfloat16, device=dev)
    count("int8_bcd", lambda: int8_pred.predict_u8(*pairs))
    cc = Change3D(Task.CC, vocab_size=CC_VOCAB, device=dev, seed=seed)
    cc_pred = CaptionPredictor(cc, cc_words(), beam_size=1, compute_dtype=torch.bfloat16,
                               device=dev)
    count("cc", lambda: cc_pred.caption_u8(*pairs))
    clf = x3d_classifier(device=dev, seed=seed)
    clip = torch.from_numpy(rs.randn(2, 16, 224, 224, 3).astype(np.float32)).to(dev,
                                                                                  torch.bfloat16)
    with torch.no_grad():
        count("x3d_m", lambda: clf(clip, classify=True))
    if counts != DEPTHWISE_PER_FORWARD:
        raise AssertionError(f"depthwise launches per forward {counts}, want "
                             f"{DEPTHWISE_PER_FORWARD}")
    del int8, int8_pred, cc, cc_pred, clf, clip
    kernels = device_kernels(lambda: preds["bcd"].predict_u8(*pairs))
    stem = preds["bcd"].model.encoder.x3d.stem
    xs = torch.zeros((batch, 3, 256, 256, 3), device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        conv_s = device_kernels(lambda: conv3d(xs, stem.conv_s, padding=(0, 1, 1)))
    per_channel = sorted(e.name for e in kernels if per_channel_conv(e.name))
    conv_s_own = sorted(e.name for e in conv_s if per_channel_conv(e.name))
    if per_channel != conv_s_own:
        raise AssertionError(f"a BCD forward ran cuDNN's per-channel conv engines beyond the "
                             f"stem's conv_s ({conv_s_own}): {per_channel}")
    busy = lambda evs: sum(e.time_range.elapsed_us() for e in evs) / 1e3
    dw_events = [e for e in kernels if "depthwise_conv3d_kernel" in e.name]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    stats = {"launches_per_forward": counts, "batch": batch,
             "bcd_profiled": {"device_ms": busy(kernels), "kernels": len(kernels),
                              "depthwise_ms": busy(dw_events), "depthwise_kernels": len(dw_events),
                              "top_kernels_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:12],
                              "per_channel_engine_kernels": per_channel,
                              "conv_s_ms": busy(conv_s),
                              "conv_s_kernels": sorted(e.name for e in conv_s)}}
    print(f"forward depthwise: {json.dumps(stats)}", flush=True)
    return stats


def depthwise_rows(dwc, dev, seed, card, iters=20):
    """The depthwise kernel's ms per launch (CUDA events over ``iters``
    launches) at each DEPTHWISE shape in bf16 at DW_BATCH on every clip and
    at X3D-M's at CLASSIFY_BATCH, on operands first held against the plain
    version: its plan, launches per forward (fused, unfused; detection, CC,
    classify), its bound (bytes in, out and the fp32 weights at 3.35
    TB/s), the plain version's ms, cuDNN's F.conv3d(groups=C) on [B, C, T,
    H, W] (library_ms) and the same with x made contiguous in that layout
    before and the output after (relayout_library_ms)."""
    rs = np.random.RandomState(seed + 19)
    cases = [(name, t, DW_BATCH, hw, c, ks, st, pad, {
                 "launches_per_forward": n_det, "launches_per_cc_forward": n_cc if t == 3 else 0,
                 "launches_per_unfused_forward": n_ud,
                 "launches_per_unfused_cc_forward": n_ucc if t == 3 else 0})
             for t in CLIPS for name, hw, c, ks, st, pad, n_det, n_cc, n_ud, n_ucc in DEPTHWISE
             if n_det or n_ud or t == 3]
    cases += [(name, t, CLASSIFY_BATCH, hw, c, ks, st, pad, {
                  "model": "x3d_m", "launches_per_classify_forward": n_f,
                  "launches_per_unfused_classify_forward": n_u})
              for name, t, hw, c, ks, st, pad, n_f, n_u in DEPTHWISE_X3DM]
    rows, worst = [], {"depthwise_conv3d": {}}
    for name, t, b, hw, c, ks, stride, pad, launches in cases:
        x, k = dw_operands(rs, b, t, hw, c, ks, torch.bfloat16, dev)
        got = dwc.depthwise_conv3d(x, k, stride=stride, padding=pad)
        hold(worst, "depthwise_conv3d", t, f"{name} T={t} B={b} timed operands", got,
             dwc.depthwise_conv3d_reference(x, k, stride, pad), torch.bfloat16)
        xc, kc = x.permute(0, 4, 1, 2, 3).contiguous(), k.to(torch.bfloat16)
        library = lambda xc: torch.nn.functional.conv3d(xc, kc, stride=stride, padding=pad,
                                                        groups=c)
        plan = dwc.plan_depthwise(t, hw, hw, c, ks, stride, pad, 2)
        nbytes = (x.numel() + got.numel()) * 2 + k.numel() * 4
        rows.append({"kernel": "depthwise_conv3d", "stage": name, "t": t, "batch": b,
                     "shape": list(x.shape), "out": list(got.shape), "kernel_size": list(ks),
                     "stride": list(stride), "plan": plan._asdict(), **launches,
                     "ms": event_ms(lambda: dwc.depthwise_conv3d(x, k, stride=stride,
                                                                 padding=pad), iters),
                     "plain_ms": event_ms(lambda: dwc.depthwise_conv3d_reference(
                         x, k, stride, pad), 3),
                     "library_ms": event_ms(lambda: library(xc), 3),
                     "relayout_library_ms": event_ms(lambda: library(
                         x.permute(0, 4, 1, 2, 3).contiguous()).permute(0, 2, 3, 4, 1)
                         .contiguous(), 3),
                     "bound_ms": nbytes / HBM_BYTES_S * 1e3, "bound_by": "bytes"})
        print(f"time depthwise_conv3d {name} T={t} B={b} ({card}): {json.dumps(rows[-1])}",
              flush=True)
        del x, k, got, xc, kc
    return rows, worst


def depthwise_per_forward(rows):
    """The depthwise rows summed over each forward at its batch: fused BCD,
    SCD, BDA and CC; unfused (int8) BCD and CC; X3D-M fused and unfused.
    Each sum's launches must equal those the forward makes."""
    dw = "depthwise_conv3d"
    per = {task: per_forward(rows, dw, CLIP_T[task], DW_BATCH) for task in TASKS}
    per["cc"] = per_forward(rows, dw, 3, DW_BATCH, "launches_per_cc_forward")
    per["int8_bcd"] = per_forward(rows, dw, 3, DW_BATCH, "launches_per_unfused_forward")
    per["unfused_cc"] = per_forward(rows, dw, 3, DW_BATCH, "launches_per_unfused_cc_forward")
    per["x3d_m"] = per_forward(rows, dw, 16, CLASSIFY_BATCH, "launches_per_classify_forward",
                               "x3d_m")
    per["unfused_x3d_m"] = per_forward(rows, dw, 16, CLASSIFY_BATCH,
                                       "launches_per_unfused_classify_forward", "x3d_m")
    want = {**DEPTHWISE_PER_FORWARD, "unfused_cc": 56, "unfused_x3d_m": 27}
    got = {name: p["launches_per_forward"] for name, p in per.items()}
    if got != want:
        raise AssertionError(f"depthwise rows sum to {got} launches per forward, want {want}")
    return per


def depthwise_only(dwc, dev, args, card) -> int:
    """``--depthwise-only``: the depthwise kernel's share of phases 2, 3 and
    5, details beside ``--out`` as ``chip_smoke_depthwise.json``."""
    seeds = list(range(args.seed, args.seed + KERNEL_SEEDS))
    worst = {}
    phase_depthwise(dwc, dev, seeds, args.batch, worst)
    forwards = phase_depthwise_forwards(dwc, dev, args.seed, DW_BATCH)
    rows, timed_worst = depthwise_rows(dwc, dev, args.seed, card)
    per_fwd = depthwise_per_forward(rows)
    out = os.path.splitext(args.out)[0] + "_depthwise.json"
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"card": card, "worst": worst, "timed_worst": timed_worst,
                   "forwards": forwards, "rows": rows, "per_forward": per_fwd}, f, indent=1)
    print(f"depthwise_conv3d per forward at batch {DW_BATCH} ({card}): "
          f"{json.dumps(per_fwd)}", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def phase_forward(pkg, dev, task, batch, n_batches, seed):
    """The task's serving forward: launches counted over --batches forwards,
    then every head's fp32 probabilities fused against plain, and the bf16
    agreement of each mask and class map with the plain bf16 model."""
    fb, Change3D, Task, Predictor, x3d_l_config = pkg
    kw = dict(num_classes=NUM_CLASSES[task], device=dev, seed=seed)
    model = Change3D(Task(task), **kw)
    pred = Predictor(model, compute_dtype=torch.bfloat16, device=dev)
    rs = np.random.RandomState(seed)
    pairs = [tuple(rs.randint(0, 256, (batch, 256, 256, 3)).astype(np.uint8) for _ in range(2))
             for _ in range(n_batches)]
    pred.predict_u8(*pairs[0])  # load the kernels, warm the allocator

    fb.fused_block_fwd.launches = 0
    fb.fused_block_se_sums.launches = 0
    maps = [pred.predict_u8(pre, post) for pre, post in pairs]
    torch.cuda.synchronize()
    launches = {"fused_block_fwd": fb.fused_block_fwd.launches,
                "fused_block_se_sums": fb.fused_block_se_sums.launches}
    want = {"fused_block_fwd": 37 * n_batches, "fused_block_se_sums": 18 * n_batches}
    if launches != want:
        raise AssertionError(f"{task} launches {launches}, want {want}")
    heads = {"bcd": ("change",), "scd": ("pre", "post", "change"), "bda": ("cls", "loc")}[task]
    for m in maps:
        if set(m) != set(heads):
            raise AssertionError(f"{task} heads {sorted(m)}")
        for key, val in m.items():
            binary = key in ("change", "loc")
            if val.shape != (batch, 256, 256) or val.dtype != (np.bool_ if binary else np.uint8):
                raise AssertionError(f"{task} {key} {val.shape} {val.dtype}")
            if not binary and int(val.max()) >= NUM_CLASSES[task]:
                raise AssertionError(f"{task} {key} class id {int(val.max())}")
    print(f"forward {task}: {n_batches} batches of {batch} pairs, launches {launches}", flush=True)

    # fp32: fused kernels against the plain path on the same weights.
    plain = Change3D(Task(task), backbone_cfg=x3d_l_config(fused_inference=False), **kw)
    plain.load_state_dict(model.state_dict())
    pre, post = pairs[0]
    norm = lambda a: (a.astype(np.float32) / 255.0 - 0.5) / 0.5
    p_fused = Predictor(model, compute_dtype=torch.float32, device=dev).predict_probs(
        norm(pre), norm(post))
    p_plain = Predictor(plain, compute_dtype=torch.float32, device=dev).predict_probs(
        norm(pre), norm(post))
    plain_pred = Predictor(plain, compute_dtype=torch.bfloat16, device=dev)
    hard_plain_bf16 = plain_pred.predict_u8(*pairs[0])
    hard_plain_fp32 = Predictor.harden(p_plain)
    stats = {}
    for key in heads:
        err = float(np.abs(p_fused[key] - p_plain[key]).max())
        if not (np.isfinite(p_fused[key]).all() and p_fused[key].shape[:3] == (batch, 256, 256)
                and err <= 1e-3):
            raise AssertionError(f"{task} {key}: fp32 fused vs plain probabilities max |d| {err}")
        stats[key] = {"fp32_prob_max_abs_err": err, "prob_mean": float(p_plain[key].mean()),
                      "bf16_agreement_vs_fp32_plain":
                          float((maps[0][key] == hard_plain_fp32[key]).mean()),
                      "bf16_agreement_vs_bf16_plain":
                          float((maps[0][key] == hard_plain_bf16[key]).mean())}
        if key in ("change", "loc"):
            stats[key]["changed_fraction"] = float((p_plain[key] > 0.5).mean())
    print(f"forward check {task}: {json.dumps(stats)}", flush=True)
    return pred, plain_pred, pairs, launches, stats


def phase_repros(rp, dev, seeds):
    """The repro kernels against their plain versions at the repros' shapes
    and at REPRO_DOT_SHAPES / REPRO_DMA_SHAPES, dot_1d reruns bit-identical,
    then their entry point as a user runs it, counted."""
    worst = {"dot_1d": {"max_abs_err": 0.0, "limit_used": 0.0},
             "manual_dma": {"max_abs_err": 0.0, "limit_used": 0.0}}

    def check_dot(x, w, what):
        got, want = rp.dot_1d(x, w), rp.dot_1d_reference(x, w)
        used = rp.bf16_ulps_used(got, want)
        err = float((got.float() - want.float()).abs().max())
        if used > 1.0 or got.shape != want.shape or not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"dot_1d {what}: max |d| {err}, {used:.3f} of two bf16 ulps")
        for k in range(REPRO_RERUNS):
            if not torch.equal(rp.dot_1d(x, w), got):
                raise AssertionError(f"dot_1d {what}: rerun {k + 1} is not bit-identical")
        w_ = worst["dot_1d"]
        w_["max_abs_err"], w_["limit_used"] = max(w_["max_abs_err"], err), max(w_["limit_used"], used)

    def check_dma(xd, what):
        err = float((rp.manual_dma(xd) - rp.manual_dma_reference(xd)).abs().max())
        if err != 0.0:
            raise AssertionError(f"manual_dma {what}: max |d| {err}, must be exact")

    for seed in seeds:
        x, w, xd = rp.repro_operands(seed, dev)
        check_dot(x, w, f"seed {seed}")
        check_dma(xd, f"seed {seed}")
    rs = np.random.RandomState(seeds[0])
    bf16 = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(torch.bfloat16).to(dev)
    for r, c, n in REPRO_DOT_SHAPES:
        check_dot(bf16(r, c), bf16(c, n), f"[{r},{c}]x[{c},{n}]")
    for shape in REPRO_DMA_SHAPES:
        check_dma(torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev), f"{list(shape)}")
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    plans = {"x".join(map(str, s)): rp.manual_dma_plan(*s, sms)._asdict()
             for s in (rp.MANUAL_DMA_SHAPE,) + REPRO_DMA_SHAPES}
    print(f"repros vs plain versions (also dot_1d at {list(REPRO_DOT_SHAPES)}, {REPRO_RERUNS} "
          f"bit-identical reruns each; manual_dma plans {json.dumps(plans)}): "
          f"{json.dumps(worst)}", flush=True)

    rp.dot_1d.launches = 0
    rp.manual_dma.launches = 0
    rp.main(seeds[0])
    torch.cuda.synchronize()
    launches = {"dot_1d": rp.dot_1d.launches, "manual_dma": rp.manual_dma.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"repro entry point launches {launches}")
    print(f"repros entry point: launches {launches}", flush=True)
    return worst, launches


def device_ms(fn, iters):
    """Device time per call of ``fn`` on the device timeline: the summed
    durations of the device events (kernels, copies) that torch.profiler
    records over ``iters`` calls after a warm-up call. Unlike event_ms it
    leaves out the host's launch gaps between calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        raise RuntimeError("the profiler trace holds no device events")
    return sum(e.time_range.elapsed_us() for e in evs) / iters / 1e3


def smi_sample() -> str:
    """The card's SM clock, power draw and power limit, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else "unknown"


def repro_rows(rp, dev, seed, card, iters=200):
    """Device time, bound, plain and library device time of each repro
    kernel at the repros' shapes, and the in-call ratios plain_ms / ms and
    library_ms / ms; the CUDA-event times of back-to-back launches (bound by
    the host's launch rate) beside them as *_events; the card's clock and
    power sampled before and after. Over the 200 launches the operands stay
    in L2 for the kernel, its plain version and the library call alike."""
    x, w, xd = rp.repro_operands(seed, dev)
    r, c, n = x.shape[0], x.shape[1], w.shape[1]
    smi_before = smi_sample()
    rows = []
    for kernel, fn, plain, library, nbytes, flops in (
        ("dot_1d", lambda: rp.dot_1d(x, w), lambda: rp.dot_1d_reference(x, w), None,
         (r * c + c * n + r * n) * 2, r * c + 2 * c * n),
        ("manual_dma", lambda: rp.manual_dma(xd), lambda: rp.manual_dma_reference(xd),
         lambda: torch.mul(xd, 2.0), 2 * xd.numel() * 4, xd.numel()),
    ):
        times = {"bytes": nbytes / HBM_BYTES_S, "operations": flops / FP32_FLOPS}
        by = max(times, key=times.get)
        rows.append({"kernel": kernel, "shape": list((x if kernel == "dot_1d" else xd).shape),
                     "ms": device_ms(fn, iters), "plain_ms": device_ms(plain, iters),
                     "library_ms": None if library is None else device_ms(library, iters),
                     "ms_events": event_ms(fn, iters), "plain_ms_events": event_ms(plain, iters),
                     "library_ms_events": None if library is None else event_ms(library, iters),
                     "bound_ms": times[by] * 1e3, "bound_by": by})
        row = rows[-1]
        row["plain_over_ms"] = row["plain_ms"] / row["ms"]
        row["library_over_ms"] = None if library is None else row["library_ms"] / row["ms"]
        print(f"time {kernel} ({card}): {json.dumps(row)}", flush=True)
    smi = {"clocks_sm,power_draw,power_limit": {"before": smi_before, "after": smi_sample()}}
    print(f"repro timings nvidia-smi: {json.dumps(smi)}", flush=True)
    for row in rows:
        row["nvidia_smi"] = smi
    return rows


def synthetic_pairs(rs, b, hw):
    """uint8 pairs whose change is three repainted squares per sample, and
    the label as a function of the pair: the pixels where |pre - post|,
    normalised and averaged over channels, exceeds 0.25."""
    pre = rs.randint(0, 256, (b, hw, hw, 3)).astype(np.uint8)
    post = pre.copy()
    for i in range(b):
        for _ in range(3):
            s = hw // 8 + rs.randint(0, hw // 8)
            y, x = rs.randint(0, hw - s, 2)
            post[i, y:y + s, x:x + s] = rs.randint(0, 256, (s, s, 3))
    diff = np.abs(pre.astype(np.float32) - post.astype(np.float32)) / 127.5
    return pre, post, (diff.mean(-1) > 0.25)[..., None].astype(np.int32)


def task_labels(rs, task, change):
    """The task's label channels around a change mask [B, H, W, 1] in
    {0, 1}: BCD the mask; SCD (label1, label2, change) with one class in
    1..5 per sample and date inside the change; BDA (loc, cls) with one
    damage class in 1..4 per sample on the changed buildings."""
    if task == "bcd":
        return change
    b = change.shape[0]
    cls = lambda lo, hi: rs.randint(lo, hi, (b, 1, 1, 1)).astype(np.int32)
    if task == "scd":
        return np.concatenate([change * cls(1, 6), change * cls(1, 6), change], axis=-1)
    return np.concatenate([change, change * cls(1, 5)], axis=-1)


def train_batch(rs, b, hw, dev, task="bcd"):
    from change3d_tpu_torch.data.transforms import eval_normalize

    pre, post, change = synthetic_pairs(rs, b, hw)
    return {"pre": torch.from_numpy(eval_normalize(pre)).to(dev),
            "post": torch.from_numpy(eval_normalize(post)).to(dev),
            "label": torch.from_numpy(task_labels(rs, task, change)).to(dev)}


# A reduced-depth backbone at full structure (stem, 3 stages with projection
# and SE blocks) for the card-vs-CPU train-step parity.
PARITY_TINY = dict(stem_dim_out=8, stage_dims=(8, 16, 24, 32), stage_inner_dims=(18, 36, 54, 72),
                   stage_depths=(2, 3, 3, 2))


def phase_train_parity(dev, seed, task="bcd"):
    """One fp32 train step (TF32 off) of the task's reduced-depth model at
    64², batch 2, on the card and on the CPU from the same weights and batch.
    Limits: loss 1e-4 relative; each gradient tensor within 1e-2 relative
    in the 2-norm, ||d|| <= 1e-2 ||ref||; BN running stats |d| <= 1e-4
    (1 + |ref|); the step's metrics (confusion matrices, counts) reported. The gradients are held normwise because single elements of
    the BN-scale gradients come out of the cancellation sum(dy x) -
    mean sum(dy), whose fp32 error on either device alone reaches 1e-3 of
    the tensor's largest element."""
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3DConfig
    from change3d_tpu_torch.train.engine import train_step
    from change3d_tpu_torch.train.optim import torch_adam

    cfg = X3DConfig(**PARITY_TINY)
    batch = train_batch(np.random.RandomState(seed), 2, 64, "cpu", task)
    kw = dict(num_classes=NUM_CLASSES[task], in_height=64, in_width=64, backbone_cfg=cfg,
              seed=seed)
    ref = Change3D(Task(task), device="cpu", **kw)
    out = {}
    for where in ("cpu", "cuda"):
        model = Change3D(Task(task), device=dev if where == "cuda" else "cpu", **kw)
        model.load_state_dict(ref.state_dict())
        opt = torch_adam(model.parameters(), weight_decay=1e-4)
        m = train_step(model, opt, lambda _: 1e-3, {k: v.to(model.encoder.perception_frames.device)
                                                  for k, v in batch.items()}, 0)
        out[where] = (float(m["loss"]), {n: p.grad.cpu() for n, p in model.named_parameters()},
                      {n: b.cpu() for n, b in model.named_buffers()},
                      {k: v.cpu() for k, v in m.items() if k != "loss"})
    (l_cpu, g_cpu, s_cpu, m_cpu), (l_gpu, g_gpu, s_gpu, m_gpu) = out["cpu"], out["cuda"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_rel, grad_worst = max((float((g_gpu[n] - r).norm() / r.norm()), n)
                               for n, r in g_cpu.items() if float(r.norm()) > 0)
    stats_used = max(float(((s_gpu[n] - r).abs() / (1e-4 * (1 + r.abs()))).max())
                     for n, r in s_cpu.items())
    metric_diff = {k: float((m_gpu[k].double() - v.double()).abs().sum()) for k, v in m_cpu.items()}
    stats = {"task": task, "loss_cpu": l_cpu, "loss_cuda": l_gpu, "loss_rel_err": loss_rel,
             "grad_rel_err_2norm": grad_rel, "grad_worst_tensor": grad_worst,
             "grad_limit_used": grad_rel / 1e-2, "bn_stats_limit_used": stats_used,
             "grad_tensors": len(g_cpu), "bn_buffers": len(s_cpu),
             "metrics_abs_diff": metric_diff}
    print(f"train parity {task} card vs cpu (fp32, 64², batch 2): {json.dumps(stats)}",
          flush=True)
    if not (math.isfinite(l_gpu) and loss_rel <= 1e-4 and grad_rel <= 1e-2 and stats_used <= 1.0):
        raise AssertionError(f"{task} train step on the card disagrees with the CPU: {stats}")
    return stats


def phase_overfit(dev, seed, batch=16, steps=10):
    """Full-width X3D-L BCD, bf16, 256²: ``steps`` Adam steps at constant lr
    2e-4 on one fixed synthetic batch; every loss finite, the last below the
    first."""
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.train.engine import train_step
    from change3d_tpu_torch.train.optim import torch_adam

    model = Change3D(Task.BCD, device=dev, seed=seed)
    opt = torch_adam(model.parameters(), weight_decay=1e-4)
    data = train_batch(np.random.RandomState(seed + 2), batch, 256, dev)
    losses = [train_step(model, opt, lambda _: 2e-4, data, k, compute_dtype=torch.bfloat16)["loss"]
              for k in range(steps)]
    losses = [float(x) for x in losses]
    print(f"overfit X3D-L bf16 256² batch {batch}, {steps} steps: losses {losses}", flush=True)
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"overfit losses {losses}")
    return model, opt, data, losses


# Label directories and file names of the synthetic layouts: LEVIR-CD,
# SECOND, and xBD (whose label files carry 'disaster_target').
LAYOUTS = {"bcd": (("label",), "{i:04d}.png"),
           "scd": (("label1", "label2", "change"), "{i:04d}.png"),
           "bda": (("label1", "label2"), "synthetic-flood_{i:08d}_post_disaster.png")}


def write_layout(root, rs, task, n_train, n_test, hw):
    """A synthetic dataset in the task's layout, written with data/png.py:
    BCD masks as 0/255, SCD and BDA labels as class ids."""
    from change3d_tpu_torch.data.png import write_png

    dirs, pattern = LAYOUTS[task]
    for split, n in (("train", n_train), ("test", n_test)):
        for d in ("t1", "t2") + dirs:
            os.makedirs(os.path.join(root, split, d))
        pre, post, change = synthetic_pairs(rs, n, hw)
        labels = change * 255 if task == "bcd" else task_labels(rs, task, change)
        for i in range(n):
            name = pattern.format(i=i)
            write_png(os.path.join(root, split, "t1", name), pre[i])
            write_png(os.path.join(root, split, "t2", name), post[i])
            for c, d in enumerate(dirs):
                write_png(os.path.join(root, split, d, name.replace("disaster", "disaster_target")),
                          labels[i, ..., c].astype(np.uint8))


def phase_train_loop(fb, seed, task="bcd", keep=None):
    """``cli <task>`` in process on two train batches and one test batch at
    the task's default batch, 256², bf16, two epochs: epoch 1's validation
    and the best-model re-evaluation are one forward each, so 2 x (37 + 18)
    fused launches; then ``--resume``. With ``keep`` (a directory) the data
    and the run stay there, and the stats name them."""
    import contextlib

    from change3d_tpu_torch import cli

    batch = TRAIN_BATCH[task]
    with (contextlib.nullcontext(keep) if keep else tempfile.TemporaryDirectory()) as tmp:
        root, save = os.path.join(tmp, "data"), os.path.join(tmp, "exp")
        write_layout(root, np.random.RandomState(seed + 3), task, 2 * batch, batch, 256)
        argv = [task, "--file_root", root, "--save_dir", save, "--max_epochs", "2",
                "--compute_dtype", "bfloat16", "--num_workers", "4", "--seed", str(seed)]
        fb.fused_block_fwd.launches = 0
        fb.fused_block_se_sums.launches = 0
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"fused_block_fwd": fb.fused_block_fwd.launches,
                    "fused_block_se_sums": fb.fused_block_se_sums.launches}
        forwards = 2
        want = {"fused_block_fwd": 37 * forwards, "fused_block_se_sums": 18 * forwards}
        if launches != want:
            raise AssertionError(f"{task} train loop launches {launches}, want {want}")
        (run_dir,) = [os.path.join(save, d) for d in os.listdir(save)]
        for name in ("best/model.pt", "ckpt/train_meta.json", "train_val_log.jsonl"):
            if not os.path.exists(os.path.join(run_dir, name)):
                raise AssertionError(f"train loop wrote no {name}")
        with open(os.path.join(run_dir, "train_val_log.jsonl")) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        val = [r for r in rows if r.get("event") == "epoch" and r["split"] == "val"]
        best = {"bcd": "F1", "scd": "IoU_mean", "bda": "overall_f1"}[task]
        if [r["epoch"] for r in val] != [1] or not 0.0 <= val[0][best] <= 1.0:
            raise AssertionError(f"{task} train loop validation log {val}")
        if res.get("steps") != 4 or "test_best" not in res:
            raise AssertionError(f"train loop result {res}")
        resumed = cli.main(argv + ["--resume"])
        if resumed["resumed_from_step"] != 4:
            raise AssertionError(f"--resume restored step {resumed['resumed_from_step']}, want 4")
    stats = {"task": task, "batch": batch, "seconds": seconds, "launches": launches,
             "validation_forwards": forwards, "epoch1_val": val[0], "test_best": res["test_best"],
             "resumed_from_step": resumed["resumed_from_step"]}
    if keep:
        stats.update(run_dir=run_dir, file_root=root)
    print(f"train loop (cli {task}, 2 epochs): {json.dumps(stats)}", flush=True)
    return launches, stats


def phase_train_times(model, opt, data, card, warmup=3, steps=10):
    """Train samples/s (host clock, synchronised at the end), device ms per
    step (CUDA events), peak memory of the steps, and validation pairs/s
    through eval_step, all on one device-resident bf16 batch; every loss
    finite."""
    from change3d_tpu_torch.train.engine import eval_step, train_step

    batch, task = data["pre"].shape[0], model.task.value
    step = lambda: train_step(model, opt, lambda _: 2e-4, data, 0, compute_dtype=torch.bfloat16)
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step()["loss"] for _ in range(steps)]
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    if not all(math.isfinite(float(x)) for x in losses):
        raise AssertionError(f"{task} train losses {[float(x) for x in losses]}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = event_ms(step, 5)
    val = lambda: eval_step(model, data, compute_dtype=torch.bfloat16)
    for _ in range(2):
        val()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        val()
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    stats = {"task": task, "batch": batch, "train_samples_per_s": steps * batch / host_s,
             "train_device_ms_per_step": step_ms, "peak_memory_bytes": peak,
             "peak_memory_gib": peak / 2 ** 30, "val_pairs_per_s": steps * batch / val_s,
             "card": card}
    print(f"train times {task} X3D-L bf16 256² batch {batch} ({card}): {json.dumps(stats)}",
          flush=True)
    return stats


def cc_words(vocab=CC_VOCAB):
    """A word map with the special tokens at their LEVIR-CC ids."""
    words = {"<pad>": 0, "<unk>": 1, "<start>": 2, "<end>": 3}
    words.update({f"w{i}": i for i in range(4, vocab)})
    return words


def phase_cc_forward(fb, dev, batch, seed):
    """The CC serving forward at full X3D-L width and depth, 256², bf16:
    CaptionPredictor.caption_u8 at beam 1 and 3 with the launch counts reset
    just before each, 51 + 25 per forward; then the fp32 memory fused
    against fused_inference=False (1e-3 of its max), the fp32 tokens equal
    at beam 1 and 3, and the bf16 tokens' agreement with the plain bf16
    model, as a share of positions."""
    from change3d_tpu_torch.inference import CaptionPredictor
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import x3d_l_config

    words = cc_words()
    model = Change3D(Task.CC, vocab_size=CC_VOCAB, device=dev, seed=seed)
    rs = np.random.RandomState(seed + 5)
    pre, post = (rs.randint(0, 256, (batch, 256, 256, 3)).astype(np.uint8) for _ in range(2))
    launches, preds = {}, {}
    for beam in (1, 3):
        pred = preds[beam] = CaptionPredictor(model, words, beam_size=beam,
                                              compute_dtype=torch.bfloat16, device=dev)
        pred.caption_u8(pre, post)  # load the kernels, warm the allocator
        torch.cuda.synchronize()
        fb.fused_block_fwd.launches = 0
        fb.fused_block_se_sums.launches = 0
        caps = pred.caption_u8(pre, post)
        torch.cuda.synchronize()
        launches[beam] = {"fused_block_fwd": fb.fused_block_fwd.launches,
                          "fused_block_se_sums": fb.fused_block_se_sums.launches}
        if launches[beam] != CC_PER_FORWARD:
            raise AssertionError(f"cc beam {beam} launches {launches[beam]}, want {CC_PER_FORWARD}")
        if len(caps) != batch or not all(isinstance(c, str) for c in caps):
            raise AssertionError(f"cc captions {caps}")
        print(f"forward cc beam {beam}: batch {batch}, launches per forward {launches[beam]}, "
              f"first caption {caps[0][:80]!r}", flush=True)

    plain = Change3D(Task.CC, backbone_cfg=x3d_l_config(fused_inference=False),
                     vocab_size=CC_VOCAB, device=dev, seed=seed)
    plain.load_state_dict(model.state_dict())
    dpre, dpost = (torch.from_numpy(a).to(dev) for a in (pre, post))
    stats = {}
    p32 = {kind: CaptionPredictor(m, words, compute_dtype=torch.float32, device=dev)
           for kind, m in (("fused", model), ("plain", plain))}
    mem = {kind: p.encode(dpre, dpost) for kind, p in p32.items()}
    err = float((mem["fused"] - mem["plain"]).abs().max() / mem["plain"].abs().max())
    if not (err <= 1e-3 and bool(torch.isfinite(mem["fused"]).all())
            and mem["fused"].shape == (batch, 256, 192)):
        raise AssertionError(f"cc fp32 memory fused vs plain: {err} of its max, "
                             f"shape {tuple(mem['fused'].shape)}")
    stats["fp32_memory_rel_err"] = err
    p16_plain = CaptionPredictor(plain, words, compute_dtype=torch.bfloat16, device=dev)
    for beam in (1, 3):
        tok = {}
        for kind, p in p32.items():
            p.beam_size = beam
            tok[kind] = p.decode(mem[kind])[0]
        if not torch.equal(tok["fused"], tok["plain"]):
            raise AssertionError(f"cc fp32 tokens fused vs plain differ at beam {beam}")
        p16_plain.beam_size = beam
        t16 = preds[beam].caption_device(dpre, dpost)[0]
        stats[f"bf16_token_agreement_beam{beam}"] = float(
            (t16 == p16_plain.caption_device(dpre, dpost)[0]).float().mean())
        stats[f"fp32_tokens_equal_beam{beam}"] = True
    print(f"forward check cc: {json.dumps(stats)}", flush=True)
    return model, preds, (pre, post), launches, stats


def lively_weights(model, seed):
    """Seeded weights whose logits can be read: every matrix and conv kernel
    of the default init scaled by sqrt(3) (U(+-sqrt(3 / fan_in))), BN scales
    and variances in [1, 1.2), BN biases and means 0.1 * N(0, 1)."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for name, v in model.state_dict().items():
            if v.dim() >= 2:
                v.mul_(3 ** 0.5)
            elif name.endswith((".scale", ".var")):
                v.copy_(torch.from_numpy(1 + 0.2 * rs.rand(*v.shape).astype(np.float32)))
            elif name.endswith((".bias", ".mean")):
                v.copy_(torch.from_numpy(0.1 * rs.randn(*v.shape).astype(np.float32)))
    return model


def block_operands(model, clip):
    """One classifying forward with ``fused_bottleneck_block`` watched (the
    name models/x3d.py calls): the operands of the first call at each
    (input shape, SE), and the calls at each."""
    from change3d_tpu_torch.models import x3d as x3d_mod

    real, ops, calls = x3d_mod.fused_bottleneck_block, {}, {}

    def watch(x, *args):
        key = (tuple(x.shape), args[-1] is not None)
        calls[key] = calls.get(key, 0) + 1
        se = None if args[-1] is None else tuple(a.detach() for a in args[-1])
        ops.setdefault(key, ([x] + [a.detach() for a in args[:-1]], se))
        return real(x, *args)

    x3d_mod.fused_bottleneck_block = watch
    try:
        with torch.no_grad():
            model(clip, classify=True)
    finally:
        x3d_mod.fused_bottleneck_block = real
    return ops, calls


def clips_per_s(model, clip, rounds=3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(rounds):
            model(clip, classify=True)
    torch.cuda.synchronize()
    return rounds * clip.shape[0] / (time.perf_counter() - t0)


def classify_rows(fb, name, ops, calls, card, iters=10):
    """Each fused kernel's time at every block shape of one bf16 forward (on
    the SE block's operands, held against the plain version just before),
    its launches per forward, its plan, bound and plain time. Where the
    plan is the split design (T-tiles shorter than the clip), its two
    launches apart too, the xa pass (``xa_ms``) and the tail on the xa
    pass's output (``tail_ms``), and beside them the staged T-tiled kernel
    (``staged_ms``, ``_plan_bf16``), whose outputs the split's equal bit for
    bit (``staged_equal``)."""
    rows = []
    for (shape, has_se), (o, se) in sorted(ops.items()):
        if not has_se:
            continue
        b, t, h, w, c = shape
        ci = o[1].shape[1]
        gate = fb.se_gate(fb.se_sums_reference(*o[:7]).sum(1) / (t * h * w), *se)
        plan = fb.plan_block(t, h, w, c, ci, 2)
        n_se = calls[(shape, True)]
        staged = fb._plan_bf16(t, h, w, c, ci)
        front = fb._front_args(*o[:7])
        xa = fb._launch_xa(*front[:4]) if plan.split else None
        for kernel, fn, plain, n, sums, tail, old in (
            ("fused_block_fwd", lambda: fb.fused_block_fwd(*o, gate),
             lambda: fb.fused_block_fwd_reference(*o, gate), n_se + calls[(shape, False)], False,
             lambda: fb._launch_fwd(*o, gate, plan=plan, xa=xa),
             lambda: fb._launch_fwd(*o, gate, plan=staged)),
            ("fused_block_se_sums", lambda: fb.fused_block_se_sums(*o[:7]),
             lambda: fb.se_sums_reference(*o[:7]), n_se, True,
             lambda: fb._launch_se_sums(*o[:7], plan=plan, xa=xa),
             lambda: fb._launch_se_sums(*o[:7], plan=staged)),
        ):
            b_ms, b_by = bound(b, t, h, c, ci, 2, sums=sums, n_tiles=plan.n_tiles)
            rows.append({"kernel": kernel, "model": name, "stage": STAGE_OF_WIDTH[c], "t": t,
                         "batch": b, "shape": list(shape), "inner": ci, "tt": plan.tt,
                         "tile": plan.tile, "chunk": plan.ck, "n_tiles": plan.n_tiles,
                         "design": ("split" if plan.split else
                                    "resident" if plan.resident else "staged"),
                         "launches_per_forward": n,
                         "blocks_per_sm": fb.blocks_per_sm(torch.bfloat16, sums, t, h, w, c, ci),
                         "ms": event_ms(fn, iters), "plain_ms": event_ms(plain, 3),
                         "bound_ms": b_ms, "bound_by": b_by, "card": card})
            if plan.split:
                rows[-1].update({
                    "xa_ms": event_ms(lambda: fb._launch_xa(*front[:4]), iters),
                    "tail_ms": event_ms(tail, iters), "staged_ms": event_ms(old, iters),
                    "staged_chunk": staged.ck, "staged_equal": bool(torch.equal(tail(), old()))})
                if not rows[-1]["staged_equal"]:
                    raise AssertionError(f"{kernel} {name} {shape}: the split design differs "
                                         f"from the staged kernel")
            print(f"time {kernel} {name} {STAGE_OF_WIDTH[c]} T={t} tt={plan.tt} B={b} "
                  f"({card}): {json.dumps(rows[-1])}", flush=True)
    return rows


def phase_classify(fb, dev, worst, seed, card):
    """X3D-M / S / XS as Kinetics classifiers (``x3d_classifier``, seeded
    weights) on their published clips at batch 8 in bf16: exactly 22 + 11
    fused launches per forward with the counts set to 0 just before, finite
    [8, 400] logits; each kernel held against its plain version on the
    operands the bf16 and the fp32 forwards give it (every block shape, with
    and without SE); the fp32 logits of the fused model against
    fused_inference=False (1e-3, equal top-1); clips/s and device ms per
    forward, fused and plain in turns; each kernel's time per shape."""
    from change3d_tpu_torch.models.x3d import X3D, x3d_classifier, x3d_m_config

    t_start = time.perf_counter()
    stats, rows = {}, []
    for name, t, side in CLASSIFY:
        model = lively_weights(x3d_classifier(device=dev, seed=seed), seed)
        rs = np.random.RandomState(seed + t)
        clip32 = torch.from_numpy(rs.randn(CLASSIFY_BATCH, t, side, side, 3).astype(
            np.float32)).to(dev)
        clip = clip32.to(torch.bfloat16)
        with torch.no_grad():
            model(clip, classify=True)  # load the kernels, warm the allocator
            torch.cuda.synchronize()
            reset_counts(fb)
            logits = model(clip, classify=True)
            torch.cuda.synchronize()
            launches = fused_counts(fb)
        if launches != CLASSIFY_PER_FORWARD:
            raise AssertionError(f"{name} launches {launches}, want {CLASSIFY_PER_FORWARD}")
        if logits.shape != (CLASSIFY_BATCH, 400) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name} logits {tuple(logits.shape)} {logits.dtype}")
        ops16, calls = block_operands(model, clip)
        for dtype, ops in ((torch.bfloat16, ops16), (torch.float32, block_operands(model, clip32)[0])):
            for (shape, has_se), (o, se) in sorted(ops.items()):
                check_block(fb, worst, f"{name} {shape} se={has_se} forward operands", o, se, dtype)
        plain = X3D(x3d_m_config(fused_inference=False), head=True).to(dev).eval()
        plain.load_state_dict(model.state_dict())
        with torch.no_grad():
            f32, p32 = model(clip32, classify=True), plain(clip32, classify=True)
            p16 = plain(clip, classify=True)
        err = float((f32 - p32).abs().max())
        if not (err <= 1e-3 and torch.equal(f32.argmax(1), p32.argmax(1))):
            raise AssertionError(f"{name} fp32 logits fused vs plain: max |d| {err}, top-1 "
                                 f"{f32.argmax(1).tolist()} vs {p32.argmax(1).tolist()}")
        runs = {"fused": [], "plain": []}
        for kind in ("fused", "plain", "plain", "fused"):
            runs[kind].append(clips_per_s(model if kind == "fused" else plain, clip))
        with torch.no_grad():
            fwd_ms = {kind: event_ms(lambda: m(clip, classify=True), 5)
                      for kind, m in (("fused", model), ("plain", plain))}
        stats[name] = {
            "frames": t, "side": side, "batch": CLASSIFY_BATCH, "launches": launches,
            "fp32_logit_max_abs_err": err, "fp32_top1_equal": True,
            "logit_max_abs": float(p32.abs().max()),
            "bf16_top1_agreement_vs_fp32_plain": float((logits.argmax(1) == p32.argmax(1))
                                                       .float().mean()),
            "bf16_top1_agreement_vs_bf16_plain": float((logits.argmax(1) == p16.argmax(1))
                                                       .float().mean()),
            "clips_per_s": runs, "forward_ms": fwd_ms, "card": card}
        rows += classify_rows(fb, name, ops16, calls, card)
        print(f"classify {name} {t}x{side}^2 bf16 batch {CLASSIFY_BATCH}: fused "
              f"{runs['fused']} clips/s, {fwd_ms['fused']} ms per forward on the device; plain "
              f"{runs['plain']} clips/s, {fwd_ms['plain']} ms ({card}); {json.dumps(stats[name])}",
              flush=True)
        del model, plain, ops16, clip, clip32
        torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t_start
    print(f"classify phase: {stats['seconds']:.1f} s", flush=True)
    return stats, rows


def classify_only(fb, dev, args, card) -> int:
    """``--classify-only``: phase 15 alone, details beside ``--out`` as
    ``chip_smoke_classify.json``."""
    worst = {"fused_block_fwd": {}, "fused_block_se_sums": {}}
    stats, rows = phase_classify(fb, dev, worst, args.seed, card)
    out = os.path.splitext(args.out)[0] + "_classify.json"
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"card": card, "classify": stats, "rows": rows, "worst": worst}, f, indent=1)
    print(f"kernels vs plain versions, worst over phase 15: {json.dumps(worst)}", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def kinetics_depthwise(dwc, dev, seed, worst, card, iters=20):
    """The depthwise kernel at X3D-L's five Kinetics shapes at B = 30: held
    against its plain version in fp32 (1e-5 * (1 + |ref|)) and bf16 (two
    ulps), then timed in bf16 (its ms, the plain version's, the bound: bytes
    in, out and the fp32 weights at 3.35 TB/s), one launch a forward each."""
    name, b, _, _ = KINETICS
    rs, rows = np.random.RandomState(seed + 29), []
    for stage, t, hw, c, ks, stride, pad in DEPTHWISE_X3DL:
        for dtype in (torch.float32, torch.bfloat16):
            x, k = dw_operands(rs, b, t, hw, c, ks, dtype, dev)
            got = dwc.depthwise_conv3d(x, k, stride=stride, padding=pad)
            hold(worst, "depthwise_conv3d", t, f"{stage} B={b}", got,
                 dwc.depthwise_conv3d_reference(x, k, stride, pad), dtype, fp32_tol=1e-5)
        plan = dwc.plan_depthwise(t, hw, hw, c, ks, stride, pad, 2)
        nbytes = (x.numel() + got.numel()) * 2 + k.numel() * 4
        rows.append({"kernel": "depthwise_conv3d", "model": name, "stage": stage, "t": t,
                     "batch": b, "shape": list(x.shape), "out": list(got.shape),
                     "kernel_size": list(ks), "stride": list(stride), "plan": plan._asdict(),
                     "launches_per_classify_forward": 1,
                     "ms": event_ms(lambda: dwc.depthwise_conv3d(x, k, stride=stride,
                                                                 padding=pad), iters),
                     "plain_ms": event_ms(lambda: dwc.depthwise_conv3d_reference(
                         x, k, stride, pad), 3),
                     "bound_ms": nbytes / HBM_BYTES_S * 1e3, "bound_by": "bytes", "card": card})
        print(f"time depthwise_conv3d {name} {stage} T={t} B={b} ({card}): "
              f"{json.dumps(rows[-1])}", flush=True)
        del x, k, got
    return rows


def phase_kinetics(fb, dwc, dev, worst, seed, card):
    """X3D-L as the Kinetics-400 classifier of the x3dl-classify-v30 cell
    (``ClipClassifier(x3d_classifier("l"))``, seeded weights) on one
    video's 30 views of uint8 16 x 312² clips in bf16: exactly 51 + 25
    fused and 5 depthwise launches in one ``classify_u8`` call with the
    counts set to 0 just before, finite [30, 400] logits; each fused kernel
    held against its plain version on the operands the bf16 and the fp32
    forwards give it (every block shape, with and without SE), the
    depthwise kernel at its five shapes; the fp32 logits of the fused model
    against fused_inference=False (1e-3 of the largest, equal top-1);
    clips/s, the forward's and the upload's device ms; each kernel's time
    per shape, summed per forward."""
    from change3d_tpu_torch.inference import ClipClassifier
    from change3d_tpu_torch.models.x3d import X3D, x3d_classifier, x3d_l_config

    t_start = time.perf_counter()
    name, b, t, side = KINETICS
    model = lively_weights(x3d_classifier("l", device=dev, seed=seed), seed)
    clf = ClipClassifier(model, device=dev)
    clips = np.random.RandomState(seed + 23).randint(0, 256, (b, t, side, side, 3),
                                                     dtype=np.uint8)
    clf.classify_u8(clips)  # load the kernels, warm the allocator
    torch.cuda.synchronize()
    reset_counts(fb)
    dwc.depthwise_conv3d.launches = 0
    logits = clf.classify_u8(clips)
    launches = {**fused_counts(fb), "depthwise_conv3d": dwc.depthwise_conv3d.launches}
    if launches != KINETICS_PER_FORWARD:
        raise AssertionError(f"{name} launches {launches}, want {KINETICS_PER_FORWARD}")
    if logits.shape != (b, 400) or not np.isfinite(logits).all():
        raise AssertionError(f"{name} logits {logits.shape} {logits.dtype}")

    u8 = torch.from_numpy(clips).to(dev)
    f32_clf = ClipClassifier(model, compute_dtype=torch.float32, device=dev)
    ops16, calls = block_operands(model, clf.normalize(u8))
    for dtype, ops in ((torch.bfloat16, ops16),
                       (torch.float32, block_operands(model, f32_clf.normalize(u8))[0])):
        for (shape, has_se), (o, se) in sorted(ops.items()):
            check_block(fb, worst, f"{name} {shape} se={has_se} forward operands", o, se, dtype)
        del ops
    plain = X3D(x3d_l_config(stem_conv_stride=(1, 2, 2), fused_inference=False),
                head=True).to(dev).eval()
    plain.load_state_dict(model.state_dict())
    f32 = f32_clf.classify_u8(clips)
    p32 = ClipClassifier(plain, compute_dtype=torch.float32, device=dev).classify_u8(clips)
    p16 = ClipClassifier(plain, device=dev).classify_u8(clips)
    del plain
    err, top = float(np.abs(f32 - p32).max()), float(np.abs(p32).max())
    if not (err <= 1e-3 * max(1.0, top) and np.array_equal(f32.argmax(1), p32.argmax(1))):
        raise AssertionError(f"{name} fp32 logits fused vs plain: max |d| {err} (largest "
                             f"{top}), top-1 {f32.argmax(1).tolist()} vs {p32.argmax(1).tolist()}")

    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(3):
            clf.classify_u8(clips)
        runs.append(3 * b / (time.perf_counter() - t0))
    fwd_ms = event_ms(lambda: clf.logits_device(u8), 5)
    h2d_ms = event_ms(lambda: clf._put(clips), 5)
    rows = classify_rows(fb, name, ops16, calls, card)
    del ops16, u8
    torch.cuda.empty_cache()
    rows += kinetics_depthwise(dwc, dev, seed, worst, card)
    per = {k: per_forward(rows, k, t, b, model=name)
           for k in ("fused_block_fwd", "fused_block_se_sums")}
    per["depthwise_conv3d"] = per_forward(rows, "depthwise_conv3d", t, b,
                                          "launches_per_classify_forward", name)
    summed = {k: p["launches_per_forward"] for k, p in per.items()}
    if summed != KINETICS_PER_FORWARD:
        raise AssertionError(f"{name} rows sum to {summed} launches, want {KINETICS_PER_FORWARD}")
    stats = {"frames": t, "side": side, "batch": b, "launches": launches,
             "fp32_logit_max_abs_err": err, "logit_max_abs": top, "fp32_top1_equal": True,
             "bf16_top1_agreement_vs_fp32_plain": float((logits.argmax(1) == p32.argmax(1))
                                                        .mean()),
             "bf16_top1_agreement_vs_bf16_plain": float((logits.argmax(1) == p16.argmax(1))
                                                        .mean()),
             "clips_per_s": runs, "forward_ms": fwd_ms, "h2d_ms": h2d_ms,
             "per_forward": per, "card": card}
    print(f"classify_u8 {name} {t}x{side}^2 bf16 batch {b}: {runs} clips/s end to end, "
          f"{fwd_ms} ms per forward and {h2d_ms} ms per upload on the device ({card}); "
          f"{json.dumps({k: v for k, v in stats.items() if k != 'per_forward'})}", flush=True)
    print(f"kernels {name} {t}x{side}^2 bf16 batch {b}, per classify_u8 forward ({card}): "
          f"{json.dumps(per)}", flush=True)
    del model, clf, f32_clf
    torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t_start
    print(f"kinetics phase: {stats['seconds']:.1f} s", flush=True)
    return stats, rows


def kinetics_only(fb, dwc, dev, args, card) -> int:
    """``--kinetics-only``: phase 16 alone, details beside ``--out`` as
    ``chip_smoke_kinetics.json``; the per-forward kernels JSON last."""
    worst = {"fused_block_fwd": {}, "fused_block_se_sums": {}, "depthwise_conv3d": {}}
    stats, rows = phase_kinetics(fb, dwc, dev, worst, args.seed, card)
    out = os.path.splitext(args.out)[0] + "_kinetics.json"
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"card": card, "kinetics": stats, "rows": rows, "worst": worst}, f, indent=1)
    print(f"kernels vs plain versions, worst over phase 16: {json.dumps(worst)}", flush=True)
    print(json.dumps({"kernels": {KINETICS[0]: stats["per_forward"]}}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def phase_cc_times(preds, pairs, batch, dev, card, rounds=3):
    """caption_u8 captions/s at ``batch`` (host clock), the encoder's and the
    decode's CUDA-event ms, the decode's device-busy ms on the profiler's
    timeline, its steps, and its host ms per step."""
    from change3d_tpu_torch.models import caption_decoder as cd

    dpre, dpost = (torch.from_numpy(a).to(dev) for a in pairs)
    out = {}
    for beam, pred in preds.items():
        pred.caption_u8(*pairs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            pred.caption_u8(*pairs)
        caps_s = rounds * batch / (time.perf_counter() - t0)
        mem = pred.encode(dpre, dpost)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.decode(mem)
        torch.cuda.synchronize()
        wall_ms, steps = (time.perf_counter() - t0) * 1e3, cd.beam_search_decode.steps
        row = {"beam": beam, "batch": batch, "captions_per_s": caps_s,
               "encoder_ms": event_ms(lambda: pred.encode(dpre, dpost), 5),
               "decode_ms": event_ms(lambda: pred.decode(mem), 3),
               "decode_device_busy_ms": device_ms(lambda: pred.decode(mem), 2),
               "decode_steps": steps, "decode_host_ms_per_step": wall_ms / steps,
               "card": card}
        out[beam] = row
        print(f"cc times beam {beam} bf16 256² batch {batch} ({card}): {json.dumps(row)}",
              flush=True)
    return out


def cc_batch(rs, b, hw, dev, vocab=CC_VOCAB):
    """ImageNet-normalised random pairs and captions of 8-20 words padded to
    CC_LEN, as the CC loader gives them."""
    norm = lambda a: ((a / 255.0 - np.array([0.485, 0.456, 0.406]))
                      / np.array([0.229, 0.224, 0.225])).astype(np.float32)
    caps = np.zeros((b, CC_LEN), np.int64)
    lengths = rs.randint(10, 23, b)
    for i, n in enumerate(lengths):
        caps[i, 0], caps[i, 1:n - 1], caps[i, n - 1] = 2, rs.randint(4, vocab, n - 2), 3
    return {"pre": torch.from_numpy(norm(rs.randint(0, 256, (b, hw, hw, 3)))).to(dev),
            "post": torch.from_numpy(norm(rs.randint(0, 256, (b, hw, hw, 3)))).to(dev),
            "caption": torch.from_numpy(caps).to(dev),
            "length": torch.from_numpy(lengths.astype(np.int64)).to(dev)}


def phase_cc_train_parity(dev, seed):
    """One fp32 CC train step (TF32 off, dropout 0, gradient values clipped
    at 5) of a reduced-depth model at 64², batch 2, on the card and on the
    CPU from the same weights and batch: loss 1e-4 relative, top1 equal,
    each gradient tensor within 1e-2 relative in the 2-norm, BN running
    stats 1e-4 (1 + |ref|)."""
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3DConfig
    from change3d_tpu_torch.train.engine import train_step
    from change3d_tpu_torch.train.optim import torch_adam

    cfg = X3DConfig(**PARITY_TINY)
    kw = dict(in_height=64, in_width=64, backbone_cfg=cfg, vocab_size=40,
              embed_dim=cfg.stage_dims[3], num_heads=4, num_layers=2, dropout=0.0, seed=seed)
    batch = cc_batch(np.random.RandomState(seed + 6), 2, 64, "cpu", vocab=40)
    ref = Change3D(Task.CC, device="cpu", **kw)
    out = {}
    for where in ("cpu", "cuda"):
        d = dev if where == "cuda" else torch.device("cpu")
        model = Change3D(Task.CC, device=d, **kw)
        model.load_state_dict(ref.state_dict())
        model.decoder.pe_dropout = 0.0
        opt = torch_adam(model.parameters(), weight_decay=1e-5, grad_clip_value=5.0)
        m = train_step(model, opt, lambda _: 1e-4, {k: v.to(d) for k, v in batch.items()}, 0,
                       generator=torch.Generator(device=d).manual_seed(0))
        out[where] = (float(m["loss"]), float(m["top1"]),
                      {n: p.grad.cpu() for n, p in model.named_parameters()},
                      {n: b.cpu() for n, b in model.named_buffers() if n != "decoder.pe"})
    (l_cpu, t_cpu, g_cpu, s_cpu), (l_gpu, t_gpu, g_gpu, s_gpu) = out["cpu"], out["cuda"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_rel, grad_worst = max((float((g_gpu[n] - r).norm() / r.norm()), n)
                               for n, r in g_cpu.items() if float(r.norm()) > 0)
    stats_used = max(float(((s_gpu[n] - r).abs() / (1e-4 * (1 + r.abs()))).max())
                     for n, r in s_cpu.items())
    stats = {"task": "cc", "loss_cpu": l_cpu, "loss_cuda": l_gpu, "loss_rel_err": loss_rel,
             "top1_cpu": t_cpu, "top1_cuda": t_gpu, "grad_rel_err_2norm": grad_rel,
             "grad_worst_tensor": grad_worst, "grad_limit_used": grad_rel / 1e-2,
             "bn_stats_limit_used": stats_used, "grad_tensors": len(g_cpu)}
    print(f"train parity cc card vs cpu (fp32, 64², batch 2, dropout 0): {json.dumps(stats)}",
          flush=True)
    if not (math.isfinite(l_gpu) and loss_rel <= 1e-4 and t_gpu == t_cpu and grad_rel <= 1e-2
            and stats_used <= 1.0):
        raise AssertionError(f"cc train step on the card disagrees with the CPU: {stats}")
    return stats


def phase_cc_train_times(dev, seed, card, warmup=3, steps=5):
    """CC training at the CLI defaults (fp32, batch 32, 256², full X3D-L,
    no remat), then bf16 at batch 32: samples/s by host clock, device ms per
    step (CUDA events), peak memory of the steps; then evaluation captions/s
    at batch 32 through the loop's decode (fp32, fused blocks, beam 1)."""
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.train.caption_loop import make_decode_fn
    from change3d_tpu_torch.train.engine import train_step
    from change3d_tpu_torch.train.optim import torch_adam

    out = {}
    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        model = Change3D(Task.CC, vocab_size=CC_VOCAB, device=dev, seed=seed)
        opt = torch_adam(model.parameters(), weight_decay=1e-5, grad_clip_value=5.0)
        data = cc_batch(np.random.RandomState(seed + 8), CC_BATCH, 256, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        step = lambda: train_step(model, opt, lambda _: 1e-4, data, 0, compute_dtype=dtype,
                                  generator=gen)
        for _ in range(warmup):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [step()["loss"] for _ in range(steps)]
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        if not all(math.isfinite(float(x)) for x in losses):
            raise AssertionError(f"cc {name} train losses {[float(x) for x in losses]}")
        peak = torch.cuda.max_memory_allocated()
        row = {"compute_dtype": name, "batch": CC_BATCH, "train_samples_per_s":
               steps * CC_BATCH / host_s, "train_device_ms_per_step": event_ms(step, 3),
               "peak_memory_bytes": peak, "peak_memory_gb": peak / 1e9, "card": card}
        if dtype is None:  # evaluation, as the loop runs it
            decode = make_decode_fn(model, 1, cc_words())
            decode(data["pre"], data["post"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                decode(data["pre"], data["post"])
            torch.cuda.synchronize()
            row["eval_captions_per_s"] = 2 * CC_BATCH / (time.perf_counter() - t0)
        out[name] = row
        print(f"train times cc X3D-L {name} 256² batch {CC_BATCH} ({card}): {json.dumps(row)}",
              flush=True)
        del model, opt, data, step
        torch.cuda.empty_cache()
    return out


def write_cc_layout(root, rs, n_train, n_test, hw, repeat=1):
    """A synthetic LEVIR-CC layout: {SPLIT}_IMAGES_SYNTH.hdf5 ([N, 2, 3, H,
    W] uint8 and captions_per_image = 5, written by data/hdf5.py as h5py
    writes them), {SPLIT}_CAPTIONS_SYNTH.json and {SPLIT}_CAPLENS_SYNTH.json
    (5 captions per image, padded to CC_LEN) and WORDMAP_SYNTH.json (40
    words). The train split holds its ``n_train`` random images ``repeat``
    times over."""
    from change3d_tpu_torch.data import hdf5

    words = cc_words(40)
    os.makedirs(root)
    for split, n in (("TRAIN", n_train), ("TEST", n_test)):
        images = rs.randint(0, 256, (n, 2, 3, hw, hw)).astype(np.uint8)
        if split == "TRAIN" and repeat > 1:
            images, n = np.tile(images, (repeat, 1, 1, 1, 1)), n * repeat
        hdf5.write_file(os.path.join(root, f"{split}_IMAGES_SYNTH.hdf5"), images,
                        {"captions_per_image": 5})
        caps, lens = [], []
        for _ in range(5 * n):
            k = rs.randint(5, 15)
            caps.append([2] + rs.randint(4, len(words), k - 2).tolist() + [3] + [0] * (CC_LEN - k))
            lens.append(k)
        for what, obj in (("CAPTIONS", caps), ("CAPLENS", lens)):
            with open(os.path.join(root, f"{split}_{what}_SYNTH.json"), "w") as f:
                json.dump(obj, f)
    with open(os.path.join(root, "WORDMAP_SYNTH.json"), "w") as f:
        json.dump(words, f)


def phase_cc_loop(fb, seed, keep=None):
    """``cli cc --loader grain`` in process on a synthetic 256² LEVIR-CC
    layout written by data/hdf5.py (13 train images = 65 caption rows, 2
    steps per epoch at batch 32; 8 test images, one eval batch of 32) at the
    CLI defaults (fp32) for 2 epochs with beam-1 evaluation after each and
    a best-model re-evaluation: 3 x (51 + 25) fused launches; then
    ``--resume`` restores step 4. ``CaptionDataset`` reads the HDF5 files
    through data/hdf5.py, the worker-process loader feeds the steps, and
    the evaluation scores METEOR through the native library
    (csrc/meteor.cpp). With ``keep`` (a directory) the data and the run stay
    there, and the stats name them."""
    import contextlib

    from change3d_tpu_torch import cli
    from change3d_tpu_torch.ops import cuda_build

    with (contextlib.nullcontext(keep) if keep else tempfile.TemporaryDirectory()) as tmp:
        root, save = os.path.join(tmp, "data"), os.path.join(tmp, "exp")
        write_cc_layout(root, np.random.RandomState(seed + 9), 13, 8, 256)
        argv = ["cc", "--file_root", root, "--dataset", "SYNTH", "--save_dir", save,
                "--epochs", "2", "--num_workers", "4", "--loader", "grain", "--seed", str(seed)]
        fb.fused_block_fwd.launches = 0
        fb.fused_block_se_sums.launches = 0
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"fused_block_fwd": fb.fused_block_fwd.launches,
                    "fused_block_se_sums": fb.fused_block_se_sums.launches}
        resumed = cli.main(argv + ["--resume"])
        if "meteor" not in cuda_build._LOADED:
            raise AssertionError("cc evaluation did not load the native METEOR library")
        forwards = 3
        want = {k: v * forwards for k, v in CC_PER_FORWARD.items()}
        if launches != want:
            raise AssertionError(f"cc train loop launches {launches}, want {want}")
        (run_dir,) = [os.path.join(save, d) for d in os.listdir(save)]
        for name in ("best/model.pt", "ckpt/train_meta.json", "train_val_log.jsonl", "res.json"):
            if not os.path.exists(os.path.join(run_dir, name)):
                raise AssertionError(f"cc train loop wrote no {name}")
        with open(os.path.join(run_dir, "train_val_log.jsonl")) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        val = [r for r in rows if r.get("event") == "epoch" and r["split"] == "val"]
        with open(os.path.join(run_dir, "ckpt", "train_meta.json")) as f:
            best = json.load(f)["best_val"]
        if [r["epoch"] for r in val] != [0, 1] or best != max(r["Bleu_4"] for r in val):
            raise AssertionError(f"cc train loop evaluation log {val}, best {best}")
        if res.get("steps") != 4 or "test_best" not in res:
            raise AssertionError(f"cc train loop result {res}")
        if resumed["resumed_from_step"] != 4:
            raise AssertionError(f"--resume restored step {resumed['resumed_from_step']}, want 4")
    stats = {"task": "cc", "reader": "CaptionDataset (HDF5, data/hdf5.py)",
             "loader": "grain (torch worker processes, 4)",
             "meteor": "native (csrc/meteor.cpp)", "batch": CC_BATCH, "seconds": seconds,
             "launches": launches, "eval_forwards": forwards, "bleu4_gate_best": best,
             "eval": val, "test_best": res["test_best"],
             "resumed_from_step": resumed["resumed_from_step"]}
    if keep:
        stats.update(run_dir=run_dir, file_root=root)
    print(f"train loop (cli cc --loader grain, 2 epochs, HDF5 through data/hdf5.py, native "
          f"METEOR): {json.dumps(stats)}", flush=True)
    return launches, stats


# Data phase: the committed fixture (written by h5py from this seed), the
# loaders' layouts (BCD train pairs at 256^2, batch 16; CC train images at
# 256^2, batch 32), the worker counts, the timed window in waves of every
# worker's prefetch, and METEOR's split (LEVIR-CC's test split: 1929 images,
# 5 references of 6-15 ids of the 40-word map).
FIXTURE = os.path.join("tests", "torch_fixtures", "levircc_tiny.hdf5")
FIXTURE_SEED, FIXTURE_SHAPE, FIXTURE_CPI = 20251017, (3, 2, 3, 16, 16), 5
DATA_BCD_PAIRS, DATA_CC_IMAGES, DATA_WORKERS = 128, 64, (2, 4, 8)
DATA_WAVES, DATA_PREFETCH = 10, 2  # DATA_PREFETCH: the grain loader's batches per worker
METEOR_IMAGES, METEOR_REFS = 1929, 5


def data_window(workers):
    """Batches timed at ``workers`` workers: DATA_WAVES waves of every
    worker's prefetch."""
    return DATA_WAVES * workers * DATA_PREFETCH


def loader_rate(loader, batch, window):
    """Seconds to the first batch of epoch 0 (the workers' start included);
    then, from the first batch of epoch 1 on (workers up, the stale end of
    epoch 0 drained), samples/s over the next ``window`` batches."""
    t0 = time.perf_counter()
    it = iter(loader)
    first = next(it)
    t1 = time.perf_counter()
    it.close()
    loader.set_epoch(1)
    if len(loader) <= window:
        raise AssertionError(f"an epoch of {len(loader)} batches holds no window of {window}")
    it = iter(loader)
    next(it)
    t2 = time.perf_counter()
    n = sum(len(b["pre"]) for _, b in zip(range(window), it))
    t3 = time.perf_counter()
    it.close()
    if len(first["pre"]) != batch or n != window * batch:
        raise AssertionError(f"loader gave {len(first['pre'])} and {n} samples")
    getattr(loader, "close", lambda: None)()
    return {"first_batch_s": t1 - t0, "samples_per_s": n / (t3 - t2), "samples": n,
            "batches": window, "seconds": t3 - t2}


def link_copies(root, split, copies):
    """Hard links that make a PNG layout's split ``copies`` times as long
    (the loaders decode every name, so the work is that of as many files)."""
    for d in os.listdir(os.path.join(root, split)):
        folder = os.path.join(root, split, d)
        names = os.listdir(folder)
        for c in range(1, copies):
            for name in names:
                os.link(os.path.join(folder, name), os.path.join(folder, f"c{c}_{name}"))


def phase_data(seed, tmp, card):
    """The data path on the card's machine: the committed h5py-written
    fixture read by data/hdf5.py equals what its seed regenerates; samples/s
    of the threaded loader and of the worker-process loader (``--loader
    grain``) at DATA_WORKERS workers on a synthetic LEVIR-CD PNG layout
    (train transforms, batch 16: DATA_BCD_PAIRS pairs, hard-linked to an
    epoch longer than the largest window) and on a LEVIR-CC HDF5 layout
    (batch 32: DATA_CC_IMAGES images, repeated as far), over
    ``data_window`` batches each by ``loader_rate``;
    native and Python METEOR seconds on a LEVIR-CC-sized split of seeded
    ids, their scores equal within 1e-12."""
    from change3d_tpu_torch.data import hdf5
    from change3d_tpu_torch.data.datasets import BCDDataset, CaptionDataset
    from change3d_tpu_torch.data.pipeline import caption_collate, make_data_loader, pair_collate
    from change3d_tpu_torch.data.transforms import make_transform_pipelines
    from change3d_tpu_torch.metrics.caption import meteor

    t0 = time.perf_counter()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), FIXTURE)
    location, attrs = hdf5.read_file(path)
    want = np.random.default_rng(FIXTURE_SEED).integers(0, 256, FIXTURE_SHAPE, dtype=np.uint8)
    if attrs != {"captions_per_image": FIXTURE_CPI} or not np.array_equal(location.map(), want):
        raise AssertionError(f"{FIXTURE} does not read as its seed: {attrs}")
    stats = {"fixture": {"path": FIXTURE, "shape": list(location.shape), "offset":
                         location.offset, "attrs": attrs, "equal_to_seed": True}}

    bcd_root, cc_root = os.path.join(tmp, "data_bcd"), os.path.join(tmp, "data_cc")
    longest = data_window(max(DATA_WORKERS)) + 1  # batches an epoch must hold
    write_layout(bcd_root, np.random.RandomState(seed + 20), "bcd", DATA_BCD_PAIRS, 1, 256)
    link_copies(bcd_root, "train", -(-longest * 16 // DATA_BCD_PAIRS))
    write_cc_layout(cc_root, np.random.RandomState(seed + 21), DATA_CC_IMAGES, 1, 256,
                    repeat=-(-longest * CC_BATCH // (5 * DATA_CC_IMAGES)))
    train_tf, _ = make_transform_pipelines("bcd", 256, 256)
    layouts = {"bcd_png_batch16": (BCDDataset(bcd_root, "train", train_tf), pair_collate, 16),
               "cc_hdf5_batch32": (CaptionDataset(cc_root, "SYNTH", "TRAIN"), caption_collate,
                                   CC_BATCH)}
    stats["loaders"] = {}
    for name, (data, collate, batch) in layouts.items():
        rows = {}
        for kind in ("threaded", "grain"):
            for workers in DATA_WORKERS:
                loader = make_data_loader(kind, data, batch, shuffle=True, seed=seed,
                                          num_workers=workers, collate=collate, drop_last=True)
                rows[f"{kind}_{workers}"] = loader_rate(loader, batch, data_window(workers))
        stats["loaders"][name] = rows

    rs = np.random.RandomState(seed + 22)
    ids = lambda: " ".join(map(str, rs.randint(4, 40, rs.randint(6, 16))))
    refs = [[ids() for _ in range(METEOR_REFS)] for _ in range(METEOR_IMAGES)]
    hyps = [ids() for _ in range(METEOR_IMAGES)]
    meteor.native_library()  # built in phase 1; loaded here, outside the timing
    scores, seconds = {}, {}
    for backend in meteor.BACKENDS:
        t1 = time.perf_counter()
        scores[backend] = meteor.corpus_meteor(refs, hyps, backend=backend)
        seconds[backend] = time.perf_counter() - t1
    if abs(scores["native"] - scores["python"]) > 1e-12 * max(1.0, abs(scores["python"])):
        raise AssertionError(f"METEOR native {scores['native']} != python {scores['python']}")
    stats["meteor"] = {"images": METEOR_IMAGES, "references": METEOR_REFS, "scores": scores,
                       "seconds": seconds, "python_over_native":
                       seconds["python"] / seconds["native"]}
    stats["seconds"] = time.perf_counter() - t0
    print(f"data phase ({card}): {json.dumps(stats)}", flush=True)
    return stats


# Kinetics head widths of X3D-L (pytorchvideo's create_x3d_head at 400 classes).
KINETICS_HEAD, KINETICS_CLASSES = 2048, 400
# Deploy phase: the served BCD buckets, the load's clients and requests per client.
SERVE_BUCKETS = (4, 8, 16)
LOAD_CLIENTS, LOAD_REQUESTS = 16, 32


def kinetics_head(rs, cfg):
    """Seeded Kinetics head weights under the port's converted names."""
    c, ci = cfg.stage_dims[-1], cfg.stage_inner_dims[-1]
    t = lambda *s: torch.from_numpy((0.05 * rs.randn(*s)).astype(np.float32))
    return {"head.pre_conv": t(c, ci), "head.pre_bn.scale": 1 + t(ci), "head.pre_bn.bias": t(ci),
            "head.pre_bn.mean": t(ci), "head.pre_bn.var": 1 + t(ci).abs(),
            "head.post_conv": t(ci, KINETICS_HEAD),
            "head.proj_w": t(KINETICS_HEAD, KINETICS_CLASSES), "head.proj_b": t(KINETICS_CLASSES)}


def reference_x3d_sd(x3d, cfg):
    """A port X3D state_dict (stages 1-4 and ``head.*``) under the
    reference's pytorchvideo names: the inverse of convert.x3d_torch_key_map."""
    from change3d_tpu_torch.checkpoint.convert import x3d_torch_key_map

    sd = {}
    for key, (port_key, kind) in x3d_torch_key_map(cfg).items():
        if kind == "skip":
            sd[key] = torch.tensor(0)
            continue
        v = x3d[port_key].detach().cpu().float()
        if kind == "pointwise":
            v = v.T[..., None, None, None]
        elif kind == "dense":
            v = v.T
        sd[key] = v.contiguous().clone()
    return sd


def reference_trainer_sd(model, seed):
    """A reference-named ``Trainer`` state_dict of a port BCD model: its own
    weights, plus the stage 4 and Kinetics head the reference keeps resident
    (seeded; the converter drops them for BCD)."""
    from change3d_tpu_torch.models.x3d import X3D

    st = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    cfg = model.backbone_cfg
    x3d = {k[len("encoder.x3d."):]: v for k, v in st.items() if k.startswith("encoder.x3d.")}
    extra = X3D(cfg, num_stages=4, generator=torch.Generator().manual_seed(seed + 1))
    x3d.update({k: v for k, v in extra.state_dict().items() if k.startswith("stage4.")})
    x3d.update(kinetics_head(np.random.RandomState(seed), cfg))
    sd = {f"encoder.x3d.{k}": v for k, v in reference_x3d_sd(x3d, cfg).items()}
    sd["encoder.perception_frames"] = st["encoder.perception_frames"].permute(0, 4, 1, 2, 3)
    for i in range(4):
        sd[f"encoder.fc.{i}.0.weight"] = st[f"encoder.fc{i}.conv"].T[:, :, None, None]
    names = {"reduce": "0.weight", "up": "1.weight", "up_bias": "1.bias"}
    for k, v in st.items():
        if k == "decoder.final":
            sd["decoder.up_c1.0.weight"] = v
        elif k.startswith("decoder."):
            _, block, name = k.split(".")
            sd[f"decoder.{block}.{names[name]}"] = v
    return {k: v.contiguous().clone() for k, v in sd.items()}


def fused_counts(fb):
    return {"fused_block_fwd": fb.fused_block_fwd.launches,
            "fused_block_se_sums": fb.fused_block_se_sums.launches}


def reset_counts(fb):
    fb.fused_block_fwd.launches = 0
    fb.fused_block_se_sums.launches = 0


def want_counts(forwards, per=(37, 18)):
    return {"fused_block_fwd": per[0] * forwards, "fused_block_se_sums": per[1] * forwards}


def cli_quiet(cli, argv):
    """``cli.main(argv)`` with its stdout captured: (result, printed text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = cli.main(argv)
    torch.cuda.synchronize()
    return result, buf.getvalue()


def phase_deploy_files(fb, dev, seed, tmp, bcd_loop):
    """Checkpoints in and runs out, through the CLI on the card: a
    reference-named BCD ``Trainer`` file -> ``convert-reference`` ->
    ``predict`` (PNGs byte-equal to a direct Predictor); a Kinetics X3D file
    -> ``verify-checkpoint`` (exit 0); ``eval`` of the ``cli bcd`` loop's run
    (its final report); ``predict --tiled`` on a 1024² scene (37 + 18
    launches per tile batch, byte-equal to a direct TiledPredictor)."""
    from change3d_tpu_torch import cli
    from change3d_tpu_torch.data.datasets import DATASETS
    from change3d_tpu_torch.data.pipeline import DataLoader, pair_collate
    from change3d_tpu_torch.data.png import encode_png_bytes, write_png
    from change3d_tpu_torch.data.transforms import eval_normalize, make_transform_pipelines
    from change3d_tpu_torch.inference import Predictor, TiledPredictor
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3D, x3d_l_config
    from change3d_tpu_torch.serving import masks_to_arrays
    from change3d_tpu_torch.utils.tiling import scene_offsets

    stats = {}
    model = Change3D(Task.BCD, device=dev, seed=seed + 5)
    ref = os.path.join(tmp, "checkpoint.pth.tar")
    torch.save({"state_dict": reference_trainer_sd(model, seed), "epoch": 3}, ref)
    run = os.path.join(tmp, "converted")
    rc, _ = cli_quiet(cli, ["convert-reference", "--model_task", "bcd", "--torch_checkpoint", ref,
                            "--out", run])
    saved = torch.load(os.path.join(run, "best", "model.pt"), map_location="cpu")
    if rc != 0 or any(not torch.equal(saved[k], v.cpu()) for k, v in model.state_dict().items()):
        raise AssertionError("convert-reference did not give back the model's weights")
    data = os.path.join(tmp, "levir")
    write_layout(data, np.random.RandomState(seed + 11), "bcd", 1, 20, 256)
    out = os.path.join(tmp, "masks")
    reset_counts(fb)
    t0 = time.perf_counter()
    rc, _ = cli_quiet(cli, ["predict", "--model_task", "bcd", "--checkpoint", run, "--file_root",
                            data, "--out", out])
    seconds = time.perf_counter() - t0
    launches = fused_counts(fb)
    if rc != 0 or launches != want_counts(2):
        raise AssertionError(f"cli predict rc {rc}, launches {launches} for 2 batches")
    pred = Predictor(model, compute_dtype=torch.bfloat16, device=dev)
    _, eval_tf = make_transform_pipelines("bcd", 256, 256)
    ds = DATASETS["bcd"](data, "test", eval_tf)
    names = [os.path.splitext(os.path.basename(p))[0] for p in ds.pre_images]
    idx = 0
    for batch in DataLoader(ds, 16, num_workers=2, collate=pair_collate, pad_final=True):
        valid = batch.pop("valid")
        maps = pred.predict(batch["pre"], batch["post"])["change"]
        for i in np.flatnonzero(valid):
            with open(os.path.join(out, f"{names[idx]}.png"), "rb") as f:
                if f.read() != encode_png_bytes(masks_to_arrays("bcd", {"change": maps[i]})[
                        "change"]):
                    raise AssertionError(f"cli predict mask {names[idx]} differs from Predictor's")
            idx += 1
    stats["convert_predict"] = {"pairs": idx, "batches": 2, "seconds": seconds,
                                "launches": launches, "byte_equal_pngs": idx,
                                "changed_fraction": float(np.mean(maps))}
    print(f"deploy: convert-reference -> predict, {idx} masks byte-equal to a direct "
          f"Predictor, {json.dumps(stats['convert_predict'])}", flush=True)

    x3d = X3D(x3d_l_config(), num_stages=4, generator=torch.Generator().manual_seed(seed + 2))
    pyth = os.path.join(tmp, "X3D_L.pyth")
    torch.save({"model_state": reference_x3d_sd(
        {**x3d.state_dict(), **kinetics_head(np.random.RandomState(seed + 2), x3d.cfg)},
        x3d.cfg), "epoch": 0}, pyth)
    report_path = os.path.join(tmp, "verify.json")
    rc, text = cli_quiet(cli, ["verify-checkpoint", "--pretrained", pyth, "--report",
                               report_path])
    with open(report_path) as f:
        report = json.load(f)
    finite = all(math.isfinite(e["mean"]) and math.isfinite(e["std"])
                 for e in report["blocks"].values())
    if rc != 0 or not finite or "strict conversion: OK" not in text:
        raise AssertionError(f"verify-checkpoint rc {rc}:\n{text}")
    print(text, flush=True)
    stats["verify_checkpoint"] = {"rc": rc, "n_params": report["n_params"],
                                  "device": report["device"], "blocks": report["blocks"]}

    rc, text = cli_quiet(cli, ["eval", "--model_task", "bcd", "--checkpoint",
                               bcd_loop["run_dir"], "--file_root", bcd_loop["file_root"],
                               "--compute_dtype", "bfloat16", "--batch_size",
                               str(TRAIN_BATCH["bcd"]), "--json"])
    scores = json.loads(text.strip().splitlines()[-1])
    if rc != 0 or scores != bcd_loop["test_best"]:
        raise AssertionError(f"cli eval {scores} != the loop's final report "
                             f"{bcd_loop['test_best']}")
    stats["eval"] = scores
    print(f"deploy: cli eval of the cli bcd run equals its final report: {json.dumps(scores)}",
          flush=True)

    scene = os.path.join(tmp, "scene")
    pre, post, change = synthetic_pairs(np.random.RandomState(seed + 12), 1, 1024)
    for d, img in (("t1", pre[0]), ("t2", post[0]), ("label", change[0, ..., 0].astype(np.uint8))):
        os.makedirs(os.path.join(scene, "test", d))
        write_png(os.path.join(scene, "test", d, "0000.png"), img)
    n_tiles = len(scene_offsets(1024, 1024, 256, 256, 32))
    tile_batches = -(-n_tiles // 16)
    tiled_out = os.path.join(tmp, "tiled")
    reset_counts(fb)
    t0 = time.perf_counter()
    rc, _ = cli_quiet(cli, ["predict", "--model_task", "bcd", "--checkpoint", run, "--file_root",
                            scene, "--out", tiled_out, "--tiled"])
    cli_seconds = time.perf_counter() - t0
    launches = fused_counts(fb)
    if rc != 0 or launches != want_counts(tile_batches):
        raise AssertionError(f"cli predict --tiled launches {launches} for {tile_batches} "
                             "tile batches")
    tiled = TiledPredictor(pred, overlap=32, batch_size=16)
    img = eval_normalize(np.concatenate([pre[0], post[0]], axis=2))
    want = tiled.predict_scene(img[..., :3], img[..., 3:])["change"]
    with open(os.path.join(tiled_out, "0000.png"), "rb") as f:
        if f.read() != encode_png_bytes(want.astype(np.uint8) * 255):
            raise AssertionError("cli predict --tiled differs from a direct TiledPredictor")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        tiled.predict_scene(img[..., :3], img[..., 3:])
        times.append((time.perf_counter() - t0) * 1e3)
    stats["tiled"] = {"scene": [1024, 1024], "tiles": n_tiles, "tile_batches": tile_batches,
                      "batch": 16, "overlap": 32, "launches": launches,
                      "scene_ms": times, "cli_seconds": cli_seconds}
    print(f"deploy: cli predict --tiled, 1024² scene: {json.dumps(stats['tiled'])}", flush=True)
    return model, stats


def start_server(service):
    """``make_server`` on 127.0.0.1 in a thread: (server, thread, client)."""
    import threading

    from change3d_tpu_torch.client import PredictClient
    from change3d_tpu_torch.serving import make_server

    httpd = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, PredictClient(f"http://127.0.0.1:{httpd.server_address[1]}")


def stop_server(httpd, thread, service):
    httpd.shutdown()
    httpd.server_close()
    service.close()
    thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")


def phase_deploy_serve(fb, dev, model, seed, card):
    """The HTTP service on 127.0.0.1 in this process: BCD at batch 16 with
    buckets 4/8/16, warmed up, then the port's PredictClient: JSON, raw and
    bulk requests byte-equal to predict_u8 on the same batch (every bucket,
    a padded one too), 37 + 18 launches per dispatched batch, a closed loop
    of LOAD_CLIENTS x LOAD_REQUESTS raw requests; then CC at batch 8, beam 1,
    51 + 25 launches per batch and caption_u8's captions."""
    import threading

    from change3d_tpu_torch.inference import CaptionPredictor, Predictor
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.serving import PredictService

    start, stop = start_server, stop_server
    rs = np.random.RandomState(seed + 13)
    pairs = lambda n: tuple(rs.randint(0, 256, (n, 256, 256, 3)).astype(np.uint8)
                            for _ in range(2))
    pred = Predictor(model, compute_dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    service = PredictService("bcd", pred, batch_size=16, buckets=SERVE_BUCKETS, warmup=True)
    stats = {"warmup_seconds": time.perf_counter() - t0}
    httpd, thread, client = start(service)
    try:
        # Served first, counted alone; the direct forwards come after.
        reset_counts(fb)
        sent = []
        for n in SERVE_BUCKETS + (3,):
            pre, post = pairs(n)
            sent.append(("bulk", pre, post,
                         client.predict_raw_many(pre[..., ::-1], post[..., ::-1])["change"]))
        for wire in ("json", "raw"):
            for _ in range(2):
                pre, post = pairs(1)
                call = client.predict if wire == "json" else client.predict_raw
                sent.append((wire, pre, post, call(pre[0, ..., ::-1], post[0, ..., ::-1])[
                    "change"][None]))
        launches, batches = fused_counts(fb), client.metrics()["batches_total"]
        if launches != want_counts(batches) or batches != len(sent):
            raise AssertionError(f"served launches {launches} over {batches} batches")
        for wire, pre, post, got in sent:
            n = len(pre)
            bucket = min(b for b in SERVE_BUCKETS if b >= n)
            pad = lambda a: np.concatenate([a, np.repeat(a[-1:], bucket - n, 0)])
            want = pred.predict_u8(pad(pre), pad(post))["change"][:n].astype(np.uint8) * 255
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"served {wire} masks ({n} pairs) differ from predict_u8")
        stats["agreement"] = {"requests": [[w, len(p)] for w, p, _, _ in sent],
                              "byte_equal": True, "batches": batches, "launches": launches}
        print(f"deploy: served masks byte-equal to predict_u8 on JSON, raw and bulk requests "
              f"(buckets {SERVE_BUCKETS}, one padded); launches {launches} over {batches} "
              f"batches", flush=True)

        load = [pairs(1) for _ in range(LOAD_CLIENTS)]
        errors = []

        def closed_loop(i):
            pre, post = load[i][0][0, ..., ::-1], load[i][1][0, ..., ::-1]
            try:
                for _ in range(LOAD_REQUESTS):
                    client.predict_raw(pre, post)
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        service.stats.reset()
        reset_counts(fb)
        threads = [threading.Thread(target=closed_loop, args=(i,)) for i in range(LOAD_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        seconds = time.perf_counter() - t0
        snap = client.metrics()
        launches = fused_counts(fb)
        total = LOAD_CLIENTS * LOAD_REQUESTS
        if (errors or any(t.is_alive() for t in threads) or snap["requests_total"] != total
                or snap["errors_total"] or launches != want_counts(snap["batches_total"])):
            raise AssertionError(f"load: errors {errors[:3]}, metrics {snap}, launches {launches}")
        stats["load"] = {"clients": LOAD_CLIENTS, "requests": total, "seconds": seconds,
                         "requests_per_s": total / seconds, "metrics": snap,
                         "launches": launches, "card": card}
        print(f"deploy: served BCD bf16 256², batch 16, buckets {SERVE_BUCKETS}: "
              f"{total / seconds} requests/s, p50 {snap['latency_s']['p50']} s, p99 "
              f"{snap['latency_s']['p99']} s, mean batch fill {snap['mean_batch_fill']} over "
              f"{snap['batches_total']} batches ({LOAD_CLIENTS} clients x {LOAD_REQUESTS} raw "
              f"requests, closed loop) ({card})", flush=True)
    finally:
        stop(httpd, thread, service)

    words = cc_words()
    cc = Change3D(Task.CC, vocab_size=len(words), device=dev, seed=seed + 6)
    cpred = CaptionPredictor(cc, words, beam_size=1, compute_dtype=torch.bfloat16, device=dev)
    service = PredictService("cc", cpred, batch_size=8, warmup=True)
    httpd, thread, client = start(service)
    try:
        reset_counts(fb)
        sent = []
        for wire in ("raw", "raw", "json"):
            pre, post = pairs(1)
            call = client.predict if wire == "json" else client.predict_raw
            sent.append((pre, post, call(pre[0, ..., ::-1], post[0, ..., ::-1])["caption"]))
        launches, batches = fused_counts(fb), client.metrics()["batches_total"]
        if launches != want_counts(batches, (51, 25)) or batches != len(sent):
            raise AssertionError(f"served cc launches {launches} over {batches} batches")
        for pre, post, got in sent:
            want = cpred.caption_u8(np.repeat(pre, 8, 0), np.repeat(post, 8, 0))[0]
            if got != want:
                raise AssertionError(f"served caption {got!r} != caption_u8's {want!r}")
        stats["cc"] = {"batch": 8, "beam": 1, "requests": len(sent), "batches": batches,
                       "launches": launches, "captions_equal": True,
                       "words": [len(c.split()) for _, _, c in sent]}
        print(f"deploy: served CC captions equal caption_u8's: {json.dumps(stats['cc'])}",
              flush=True)
    finally:
        stop(httpd, thread, service)
    return stats


# Export phase: the batches one symbolic BCD artifact runs at, the CC beams,
# and the served artifact's closed loop (clients, requests per client).
EXPORT_BATCHES = (4, 8, 16)
EXPORT_BEAMS = (1, 3)
ARTIFACT_CLIENTS, ARTIFACT_REQUESTS = 16, 16


def start_cli(argv, log):
    """``python -m change3d_tpu_torch.cli argv`` in a subprocess from the
    repository root, its output to the file ``log``."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m", "change3d_tpu_torch.cli", *argv],
                                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=f,
                                stderr=subprocess.STDOUT)


def program_devices(program):
    """The device types an exported program names: weights, constants,
    tensor metadata and device arguments, in every (loop body) graph."""
    devs = {t.device.type for t in (*program.state_dict.values(), *program.constants.values())
            if isinstance(t, torch.Tensor)}
    for mod in program.graph_module.modules():
        if isinstance(mod, torch.fx.GraphModule):
            for node in mod.graph.nodes:
                if isinstance(node.meta.get("val"), torch.Tensor):
                    devs.add(node.meta["val"].device.type)
                if "device" in node.kwargs:
                    devs.add(torch.device(node.kwargs["device"]).type)
    return sorted(devs)


def float_pairs_per_s(pred, pairs, batch, rounds=3):
    """End to end on the float path: normalised fp32 host arrays in,
    hardened masks out (``predict``), host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        for pre, post in pairs:
            pred.predict(pre, post)
    return rounds * len(pairs) * batch / (time.perf_counter() - t0)


def phase_export(fb, dev, seed, tmp, bcd_loop, cc_loop, card):
    """Export, the artifact predictors and profiling, on phase 9's runs.
    Four ``cli export`` processes run at once: the ``cli bcd`` run on the
    card (symbolic batch) and on the CPU pinned to batch 8, the ``cli cc``
    run at beam 1 on the CPU and at beam 3 on the card. Meanwhile ``cli bcd
    --profile_dir`` trains here on a small layout until its window closes,
    and its trace must hold CUDA kernel events; then the BCD artifacts are
    checked while the CC exports finish. ``ArtifactPredictor``: masks equal
    to the live ``Predictor.predict`` on the same float batch at every
    EXPORT_BATCHES size, probabilities within the bf16 limit, exactly 37 + 18
    launches per artifact forward; the same for the CPU-exported artifact
    moved to the card (only the card in its graph), which a PredictService
    at --batch_size 16 refuses. ``CaptionArtifactPredictor``: captions equal
    to ``CaptionPredictor``'s at each beam, 51 + 25 launches per call. Once
    every export is done (a quiet host): the symbolic BCD artifact served in
    process (masks equal to ``ArtifactPredictor.predict`` on the same batch,
    a closed loop for requests/s and p50 / p99), and artifact vs live
    float-path pairs/s at batch 8 in turns."""
    import threading

    from change3d_tpu_torch import cli
    from change3d_tpu_torch.data.datasets import CaptionDataset
    from change3d_tpu_torch.data.transforms import eval_normalize
    from change3d_tpu_torch.inference import (
        ArtifactPredictor,
        CaptionArtifactPredictor,
        CaptionPredictor,
        Predictor,
    )
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.serving import PredictService
    from change3d_tpu_torch.train.caption_loop import (
        CaptionRunConfig,
        build_caption_model,
        load_word_map,
    )

    rs = np.random.RandomState(seed + 14)
    u8 = lambda n: rs.randint(0, 256, (n, 256, 256, 3)).astype(np.uint8)
    bcd_argv = ["export", "--model_task", "bcd", "--checkpoint", bcd_loop["run_dir"]]
    cc_argv = ["export", "--model_task", "cc", "--checkpoint", cc_loop["run_dir"], "--file_root",
               cc_loop["file_root"], "--dataset", "SYNTH"]
    exports = {"bcd": bcd_argv + ["--device", "cuda"],
               "bcd_cpu_b8": bcd_argv + ["--device", "cpu", "--batch", "8"],
               "cc_beam1": cc_argv + ["--device", "cpu", "--beam_size", "1"],
               "cc_beam3": cc_argv + ["--device", "cuda", "--beam_size", "3"]}
    out = {name: os.path.join(tmp, f"{name}.pt2") for name in exports}
    stats = {"export_seconds": {}, "exported_on": {}, "artifact_bytes": {}}
    t0 = time.perf_counter()
    jobs = {name: start_cli(argv + ["--out", out[name]], out[name] + ".log")
            for name, argv in exports.items()}

    def finish(name):
        """Wait for one export; check its exit and its line."""
        jobs[name].wait(timeout=600)
        stats["export_seconds"][name] = time.perf_counter() - t0
        stats["exported_on"][name] = exports[name][exports[name].index("--device") + 1]
        with open(out[name] + ".log") as f:
            text = f.read()
        if jobs[name].returncode != 0 or f"exported {os.path.getsize(out[name])} bytes to " \
                                         f"{out[name]}" not in text.splitlines():
            raise AssertionError(f"cli export {name} exited {jobs[name].returncode}:\n{text}")
        stats["artifact_bytes"][name] = os.path.getsize(out[name])

    try:
        # The profiled run: 16 steps at batch 1 on a 64² layout (the trace
        # is checked, not timed; it shares the host with the exports).
        prof_root, prof_dir = os.path.join(tmp, "profile_data"), os.path.join(tmp, "profile")
        write_layout(prof_root, np.random.RandomState(seed + 15), "bcd", 16, 1, 64)
        t1 = time.perf_counter()
        cli_quiet(cli, ["bcd", "--file_root", prof_root, "--save_dir",
                        os.path.join(tmp, "profile_run"), "--in_height", "64", "--in_width", "64",
                        "--max_epochs", "1", "--batch_size", "1", "--num_workers", "2",
                        "--seed", str(seed), "--profile_dir", prof_dir])
        profile_seconds = time.perf_counter() - t1

        finish("bcd")
        finish("bcd_cpu_b8")
        live = Predictor.from_checkpoint(Change3D(Task.BCD, device=dev, seed=seed),
                                         bcd_loop["run_dir"], compute_dtype=torch.bfloat16,
                                         device=dev)
        art = ArtifactPredictor(out["bcd"])
        if art.fixed_batch is not None or (art.model.in_height, art.model.in_width) != (256, 256):
            raise AssertionError(f"symbolic artifact reads batch {art.fixed_batch}")

        def hold_artifact(pred, b, what):
            pre, post = eval_normalize(u8(b)), eval_normalize(u8(b))
            reset_counts(fb)
            probs = pred.predict_probs(pre, post)  # fetched to the host: launches done
            launches = fused_counts(fb)
            want = live.predict_probs(pre, post)
            ok, err, used = within(torch.from_numpy(probs["change"]),
                                   torch.from_numpy(want["change"]), torch.bfloat16)
            equal = np.array_equal(Predictor.harden(probs)["change"],
                                   Predictor.harden(want)["change"])
            if launches != want_counts(1) or not ok or not equal:
                raise AssertionError(f"{what} batch {b}: launches {launches}, max |d| {err} "
                                     f"({used} of the limit), masks equal {equal}")
            return {"launches": launches, "max_abs_err": err, "limit_used": used,
                    "masks_equal": equal}

        stats["bcd"] = {str(b): hold_artifact(art, b, "symbolic BCD artifact")
                        for b in EXPORT_BATCHES}
        cpu_art = ArtifactPredictor(out["bcd_cpu_b8"])
        devices = program_devices(cpu_art._fn.program)
        if cpu_art.fixed_batch != 8 or devices != ["cuda"]:
            raise AssertionError(f"CPU-exported artifact: batch {cpu_art.fixed_batch}, devices "
                                 f"{devices}")
        stats["bcd_cpu_b8"] = {"devices": devices, **hold_artifact(cpu_art, 8, "CPU-exported")}
        try:
            PredictService("bcd", cpu_art, batch_size=16)
            raise AssertionError("a batch-8 artifact was served at --batch_size 16")
        except ValueError as e:
            if "pinned batch of 8" not in str(e):
                raise
            stats["bcd_cpu_b8"]["refusal"] = str(e)
        del cpu_art
        print(f"export: BCD artifact masks equal the live Predictor at batches "
              f"{EXPORT_BATCHES}, 37 + 18 launches per forward; CPU-exported batch-8 artifact "
              f"on the card: {json.dumps(stats['bcd_cpu_b8'])}", flush=True)

        cfg = CaptionRunConfig(file_root=cc_loop["file_root"], dataset="SYNTH", device="cuda")
        words = load_word_map(cfg)
        norm = lambda a: (a.astype(np.float32) / 255.0 - CaptionDataset.MEAN) / CaptionDataset.STD
        pre, post = norm(u8(8)), norm(u8(8))
        stats["cc"] = {}
        for beam in EXPORT_BEAMS:
            finish(f"cc_beam{beam}")
            cart = CaptionArtifactPredictor(out[f"cc_beam{beam}"], words)
            devices = program_devices(cart._fn.program)
            reset_counts(fb)
            t1 = time.perf_counter()
            caps = cart.caption(pre, post)
            ms = (time.perf_counter() - t1) * 1e3
            launches = fused_counts(fb)
            live_cc = CaptionPredictor.from_checkpoint(
                build_caption_model(cfg, len(words)), cc_loop["run_dir"], word_map=words,
                beam_size=beam, compute_dtype=torch.bfloat16, device=dev)
            want = live_cc.caption(pre, post)
            if launches != want_counts(1, (51, 25)) or caps != want or devices != ["cuda"]:
                raise AssertionError(f"cc beam {beam}: launches {launches}, devices {devices}, "
                                     f"captions {caps} != {want}")
            stats["cc"][str(beam)] = {"launches": launches, "captions_equal": True, "batch": 8,
                                      "devices": devices, "first_call_ms": ms,
                                      "exported_on": stats["exported_on"][f"cc_beam{beam}"],
                                      "words": [len(c.split()) for c in caps]}
            del cart, live_cc
    finally:
        for proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"export: cli export seconds (four processes together, each from their start) "
          f"{json.dumps(stats['export_seconds'])}, artifact bytes "
          f"{json.dumps(stats['artifact_bytes'])}", flush=True)
    print(f"export: CC artifact captions equal CaptionPredictor's: {json.dumps(stats['cc'])}",
          flush=True)

    traces = os.listdir(prof_dir)
    if len(traces) != 1 or not traces[0].startswith("steps_10-14."):
        raise AssertionError(f"--profile_dir wrote {traces}")
    with open(os.path.join(prof_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError("the profiler trace holds no CUDA kernel events")
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    stats["profile"] = {"trace": traces[0], "trace_bytes": os.path.getsize(
        os.path.join(prof_dir, traces[0])), "seconds": profile_seconds,
        "kernel_events": len(kernels), "kernel_us": sum(by_name.values()),
        "top_kernels_us": [[n[:80], us] for n, us in top], "batch": 1, "hw": 64}
    print(f"export: cli bcd --profile_dir (64², batch 1) traced steps 10-14: {len(kernels)} "
          f"CUDA kernel events, {stats['profile']['kernel_us']:.0f} us of kernel time ({card})",
          flush=True)

    service = PredictService("bcd", art, batch_size=16, warmup=True)
    httpd, thread, client = start_server(service)
    try:
        reset_counts(fb)
        sent = []
        for n in EXPORT_BATCHES + (3,):
            p, q = u8(n), u8(n)
            sent.append((p, q, client.predict_raw_many(p[..., ::-1], q[..., ::-1])["change"]))
        for _ in range(2):
            p, q = u8(1), u8(1)
            sent.append((p, q, client.predict_raw(p[0, ..., ::-1], q[0, ..., ::-1])["change"][
                None]))
        launches, batches = fused_counts(fb), client.metrics()["batches_total"]
        if launches != want_counts(batches) or batches != len(sent):
            raise AssertionError(f"served artifact launches {launches} over {batches} batches")
        for p, q, got in sent:
            n = len(p)
            bucket = min(b for b in service.buckets if b >= n)
            pad = lambda a: eval_normalize(np.concatenate([a, np.repeat(a[-1:], bucket - n, 0)]))
            want = art.predict(pad(p), pad(q))["change"][:n].astype(np.uint8) * 255
            if not np.array_equal(got, want):
                raise AssertionError(f"served artifact masks ({n} pairs) differ")
        stats["served"] = {"buckets": list(service.buckets),
                           "requests": [len(p) for p, _, _ in sent], "batches": batches,
                           "launches": launches, "masks_equal": True}
        load = [(u8(1)[0, ..., ::-1], u8(1)[0, ..., ::-1]) for _ in range(ARTIFACT_CLIENTS)]
        errors = []

        def closed_loop(i):
            try:
                for _ in range(ARTIFACT_REQUESTS):
                    client.predict_raw(*load[i])
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        service.stats.reset()
        threads = [threading.Thread(target=closed_loop, args=(i,))
                   for i in range(ARTIFACT_CLIENTS)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        seconds = time.perf_counter() - t1
        snap = client.metrics()
        total = ARTIFACT_CLIENTS * ARTIFACT_REQUESTS
        if errors or any(t.is_alive() for t in threads) or snap["requests_total"] != total \
                or snap["errors_total"]:
            raise AssertionError(f"artifact load: errors {errors[:3]}, metrics {snap}")
        stats["served"]["load"] = {"clients": ARTIFACT_CLIENTS, "requests": total,
                                   "seconds": seconds, "requests_per_s": total / seconds,
                                   "metrics": snap, "card": card}
        print(f"export: served BCD artifact (float path), bf16 256², batch 16, buckets "
              f"{list(service.buckets)}: {total / seconds} requests/s, p50 "
              f"{snap['latency_s']['p50']} s, p99 {snap['latency_s']['p99']} s, mean batch fill "
              f"{snap['mean_batch_fill']} ({ARTIFACT_CLIENTS} clients x {ARTIFACT_REQUESTS} raw "
              f"requests, closed loop); masks equal ArtifactPredictor.predict ({card})",
              flush=True)
    finally:
        stop_server(httpd, thread, service)

    pairs = [(eval_normalize(u8(8)), eval_normalize(u8(8))) for _ in range(2)]
    for pred in (art, live):
        pred.predict(*pairs[0])  # warm
    rates = {"artifact": [], "live": []}
    for name, pred in (("artifact", art), ("live", live), ("live", live), ("artifact", art)):
        rates[name].append(float_pairs_per_s(pred, pairs, 8))
    stats["float_pairs_per_s_batch8"] = {**rates, "card": card}
    print(f"export: float-path predict pairs/s at batch 8 (turns artifact, live, live, "
          f"artifact): artifact {rates['artifact']}, live {rates['live']} ({card})", flush=True)
    return stats


# Phase 12: the deadline of its processes, and the pairs of the sharded
# predictor's check per card.
MULTI_GPU_TIMEOUT, SHARD_PAIRS_PER_CARD = 240, 8


def rank_worker(spec_path) -> int:
    """One process of phase 12: ``cli.main`` for each argv of the spec in
    turn, the fused launch counts set to 0 just before each and read just
    after, then what the process group says; all of it to the spec's
    ``out``."""
    import torch.distributed as dist

    from change3d_tpu_torch import cli
    from change3d_tpu_torch.ops import fused_block as fb

    with open(spec_path) as f:
        spec = json.load(f)
    runs = []
    for argv in spec["runs"]:
        reset_counts(fb)
        t0 = time.perf_counter()
        result = cli.main(argv)
        torch.cuda.synchronize()
        runs.append({"result": result, "launches": fused_counts(fb),
                     "seconds": time.perf_counter() - t0})
    info = {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "rank": dist.get_rank(), "device": torch.cuda.current_device(), "runs": runs}
    dist.destroy_process_group()
    with open(spec["out"], "w") as f:
        json.dump(info, f)
    return 0


def start_ranks(tmp, name, argv, n):
    """``n`` processes of this script's ``--rank-worker``, process i running
    ``argv`` and then ``argv --resume`` as process i of n over NCCL."""
    port = free_port()
    procs = []
    for i in range(n):
        flags = ["--coordinator_address", f"127.0.0.1:{port}", "--num_processes", str(n),
                 "--process_id", str(i)]
        spec = {"runs": [argv + flags, argv + flags + ["--resume"]],
                "out": os.path.join(tmp, f"{name}-{i}.json")}
        spec_path = os.path.join(tmp, f"{name}-{i}.spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        log = open(os.path.join(tmp, f"{name}-{i}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                        "--rank-worker", spec_path],
                                       cwd=os.path.dirname(os.path.abspath(__file__)),
                                       stdout=log, stderr=subprocess.STDOUT), log, spec["out"]))
    return procs


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_ranks(procs, deadline):
    """Every process's info; raises (with the end of its log) if one fails
    or outlives ``deadline`` (every process is stopped first)."""
    failed = []
    for proc, log, _ in procs:
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            failed.append(log.name)
        else:
            if proc.returncode != 0:
                failed.append(log.name)
    for proc, log, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    if failed:
        tails = []
        for name in failed:
            with open(name) as f:
                tails.append(f"{name}:\n" + "".join(f.readlines()[-30:]))
        raise AssertionError("phase 12 processes failed or hung:\n" + "\n".join(tails))
    infos = []
    for _, _, out in procs:
        with open(out) as f:
            infos.append(json.load(f))
    return infos


def phase_multi_gpu(fb, dev, seed, tmp, bcd_root, cc_root):
    """``cli bcd`` and ``cli cc`` as N = torch.cuda.device_count()
    processes, one per card, over NCCL (this script's ``--rank-worker``),
    the N of one task at once: phase 9's layouts at 256², bf16 BCD at batch
    16 and fp32 CC at batch 32 (global), two epochs, then ``--resume``. Each
    process: NCCL up with world N on card i, (37 + 18) fused launches per
    validation forward (2 forwards) and 1 for the resumed run's
    re-evaluation, (51 + 25) per CC evaluation (3, then 1), every
    process's report equal, resumed at step 4. Then a ``shard=True``
    Predictor over every card against the single-device one on the same
    per-card slices: masks equal, (37 + 18) launches per card per batch."""
    from change3d_tpu_torch.inference import Predictor
    from change3d_tpu_torch.models.trainer import Change3D, Task

    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    bcd_argv = ["bcd", "--file_root", bcd_root, "--save_dir", os.path.join(tmp, "mg_bcd"),
                "--max_epochs", "2", "--compute_dtype", "bfloat16", "--num_workers", "4",
                "--seed", str(seed)]
    cc_argv = ["cc", "--file_root", cc_root, "--dataset", "SYNTH", "--save_dir",
               os.path.join(tmp, "mg_cc"), "--epochs", "2", "--num_workers", "4",
               "--seed", str(seed)]
    torch.cuda.empty_cache()
    parent_gb = torch.cuda.memory_reserved() / 1e9
    # One task at a time: CC's fp32 step alone peaks near 53 GB per card.
    infos = []
    for name, argv in (("mg_bcd", bcd_argv), ("mg_cc", cc_argv)):
        infos += wait_ranks(start_ranks(tmp, name, argv, n),
                            time.monotonic() + MULTI_GPU_TIMEOUT)
    stats = {"processes": n, "parent_reserved_gb": parent_gb,
             "reader": "CaptionDataset (HDF5, data/hdf5.py)"}
    for name, forwards, per in (("bcd", (2, 1), (37, 18)), ("cc", (3, 1), (51, 25))):
        mine = infos[:n] if name == "bcd" else infos[n:]
        for i, info in enumerate(mine):
            if (info["backend"], info["world"], info["rank"], info["device"]) != (
                    "nccl", n, i, i % n):
                raise AssertionError(f"{name} process {i}: {info['backend']} world "
                                     f"{info['world']} rank {info['rank']} card {info['device']}")
            for run, k in zip(info["runs"], forwards):
                if run["launches"] != want_counts(k, per):
                    raise AssertionError(f"{name} process {i} launches {run['launches']}, want "
                                         f"{want_counts(k, per)}")
            if info["runs"][0]["result"].get("steps") != 4 or \
                    info["runs"][1]["result"]["resumed_from_step"] != 4:
                raise AssertionError(f"{name} process {i}: {info['runs']}")
            for run, first in zip(info["runs"], mine[0]["runs"]):
                if run["result"] != first["result"]:
                    raise AssertionError(f"{name} process {i} reports {run['result']}, "
                                         f"process 0 {first['result']}")
        stats[name] = {"launches": [info["runs"][0]["launches"] for info in mine],
                       "resume_launches": [info["runs"][1]["launches"] for info in mine],
                       "seconds": [info["runs"][0]["seconds"] for info in mine],
                       "test_best": mine[0]["runs"][0]["result"]["test_best"]}

    model = Change3D(Task.BCD, device=dev, seed=seed)
    single = Predictor(model, device=dev)
    sharded = Predictor(Change3D(Task.BCD, device=dev, seed=seed), shard=True)
    if sharded.batch_divisor != n or len(sharded.replicas) != n:
        raise AssertionError(f"shard=True holds {len(sharded.replicas)} replicas, want {n}")
    k = SHARD_PAIRS_PER_CARD
    pre, post, _ = synthetic_pairs(np.random.RandomState(seed + 12), k * n, 256)
    # One card on the same slices: at another batch the bf16 convs may take
    # other algorithms and flip a pixel at the threshold.
    parts = [single.predict_u8(pre[i * k:(i + 1) * k], post[i * k:(i + 1) * k]) for i in range(n)]
    want = {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}
    reset_counts(fb)
    got = sharded.predict_u8(pre, post)
    for d in sharded.devices:
        torch.cuda.synchronize(d)
    launches = fused_counts(fb)
    if launches != want_counts(n):
        raise AssertionError(f"sharded predictor launches {launches}, want {want_counts(n)}")
    if not all(np.array_equal(got[key], want[key]) for key in want):
        raise AssertionError("the sharded predictor's masks differ from the single device's")
    stats["shard"] = {"cards": n, "batch": k * n, "launches": launches, "masks_equal": True}
    stats["seconds"] = time.perf_counter() - t0
    print(f"multi-GPU ({n} process(es), NCCL, {stats['reader']}): {json.dumps(stats)}",
          flush=True)
    return stats


def pairs_per_s(pred, pairs, batch, rounds=3):
    """End to end: uint8 host arrays in, masks and class maps out, host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        for pre, post in pairs:
            pred.predict_u8(pre, post)
    return rounds * len(pairs) * batch / (time.perf_counter() - t0)


def serving_times(pred, plain_pred, pairs, batch, dev):
    """pairs/s of the fused forward and the plain one (fused_inference=False)
    in turns, fused, plain, plain, fused; device ms per forward of each."""
    for p in (pred, plain_pred):
        p.predict_u8(*pairs[0])
    runs = {"fused": [], "plain": []}
    for kind in ("fused", "plain", "plain", "fused"):
        runs[kind].append(pairs_per_s(pred if kind == "fused" else plain_pred, pairs, batch))
    dev_pre, dev_post = (torch.from_numpy(a).to(dev) for a in pairs[0])
    fwd_ms = {kind: event_ms(lambda: p.predict_u8_device(dev_pre, dev_post), 5)
              for kind, p in (("fused", pred), ("plain", plain_pred))}
    return runs, fwd_ms


def kernel_rows(fb, worst, batch, dev, seed, card, iters=10):
    """Each fused kernel's time per stage shape and clip length T at
    ``batch``, and at T = 3 at CC's batch (32), on bf16 operands first held
    against the plain version."""
    rs = np.random.RandomState(seed + 1)
    rows = []
    for t, b in [(t, batch) for t in CLIPS] + [(3, CC_BATCH)]:
        for name, hw, c, ci, cr, n_fwd, n_sums in STAGES:
            ops, se = operands(rs, b, t, hw, c, ci, cr, torch.bfloat16, dev, True)
            check_block(fb, worst, f"{name} T={t} B={b} timed operands", ops, se,
                        torch.bfloat16)
            gate = fb.se_gate(fb.se_sums_reference(*ops[:7]).sum(1) / (t * hw * hw), *se)
            tile, ck, _, _, n_tiles = fb.plan_tiles(t, hw, hw, c, ci, 2)
            cc_fwd, cc_sums = CC_LAUNCHES[name] if t == 3 else (0, 0)
            for kernel, fn, plain, n_launch, n_cc, sums in (
                ("fused_block_fwd", lambda: fb.fused_block_fwd(*ops, gate),
                 lambda: fb.fused_block_fwd_reference(*ops, gate), n_fwd, cc_fwd, False),
                ("fused_block_se_sums", lambda: fb.fused_block_se_sums(*ops[:7]),
                 lambda: fb.se_sums_reference(*ops[:7]), n_sums, cc_sums, True),
            ):
                b_ms, b_by = bound(b, t, hw, c, ci, 2, sums=sums, n_tiles=n_tiles)
                rows.append({"kernel": kernel, "stage": name, "t": t, "batch": b,
                             "shape": [b, t, hw, hw, c], "inner": ci,
                             "tile": tile, "chunk": ck,
                             "launches_per_forward": n_launch if b == batch else 0,
                             "launches_per_cc_forward": n_cc,
                             "blocks_per_sm": fb.blocks_per_sm(torch.bfloat16, sums, t, hw, hw,
                                                               c, ci),
                             "ms": event_ms(fn, iters), "plain_ms": event_ms(plain, 3),
                             "bound_ms": b_ms, "bound_by": b_by})
                print(f"time {kernel} {name} T={t} B={b} ({card}): {json.dumps(rows[-1])}",
                      flush=True)
    return rows


def per_forward(rows, kernel, t, batch, launches="launches_per_forward", model=None):
    """A kernel's summed ms, plain ms, bound and (where its rows time one)
    library call over one forward on T-frame clips at ``batch``
    (``launches`` names the row's launch count: a detection forward's, or a
    CC forward's; ``model`` a classifier's rows), and what bounds most of it;
    the relayouts around the library call too where every row times them."""
    mine = [r for r in rows if r["kernel"] == kernel and r["t"] == t and r["batch"] == batch
            and r.get("model") == model and r[launches]]
    total = lambda k: sum(r[k] * r[launches] for r in mine)
    by = {}
    for r in mine:
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"] * r[launches]
    library = all(r.get("library_ms") is not None for r in mine)
    out = {"ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
           "library_ms": total("library_ms") if library else None,
           "bound_by": max(by, key=by.get), "batch": batch,
           "launches_per_forward": sum(r[launches] for r in mine)}
    if all("relayout_library_ms" in r for r in mine):
        out["relayout_library_ms"] = total("relayout_library_ms")
    return out


def multi_gpu_only(fb, dev, args, card) -> int:
    """``--multi-gpu-only``: phase 12 on freshly written 256² layouts (as
    phase 9 writes them), details to ``{args.out}`` with ``_multi_gpu``
    before its extension."""
    with tempfile.TemporaryDirectory() as tmp:
        bcd_root, cc_root = os.path.join(tmp, "bcd"), os.path.join(tmp, "cc")
        write_layout(bcd_root, np.random.RandomState(args.seed + 3), "bcd", 32, 16, 256)
        write_cc_layout(cc_root, np.random.RandomState(args.seed + 9), 13, 8, 256)
        stats = phase_multi_gpu(fb, dev, args.seed, tmp, bcd_root, cc_root)
    out = os.path.splitext(args.out)[0] + "_multi_gpu.json"
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"card": card, "multi_gpu": stats}, f, indent=1)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def data_only(fb, dev, args, card) -> int:
    """``--data-only``: the data phase, then phase 9's ``cli cc`` run
    (HDF5, ``--loader grain``, native METEOR), details beside ``--out`` as
    ``chip_smoke_data.json``."""
    with tempfile.TemporaryDirectory() as tmp:
        stats = {"data": phase_data(args.seed, tmp, card)}
        launches, stats["cc_loop"] = phase_cc_loop(fb, args.seed)
    out = os.path.splitext(args.out)[0] + "_data.json"
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"card": card, **stats}, f, indent=1)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def int8_only(fb, dev, args, card) -> int:
    """``--int8-only``: phase 9's ``cli bcd`` run, then phase 13 on it."""
    with tempfile.TemporaryDirectory() as tmp:
        _, bcd_loop = phase_train_loop(fb, args.seed, "bcd", keep=os.path.join(tmp, "bcd_loop"))
        stats = phase_quant(fb, dev, args.seed, tmp, bcd_loop, card, args.batch)
    out = os.path.splitext(args.out)[0] + "_int8.json"
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"card": card, "quant": stats}, f, indent=1)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# Phase 13: int8 products per forward (two per res-block: 40 blocks on the
# detection paths, 55 with stage 4), the confident-pixel agreement an int8
# model must reach with the fused bf16 one (the JAX tests' threshold), the
# static calibration's batches, and the remat step's tolerances.
INT8_PER_FORWARD = {"bcd": 80, "scd": 80, "bda": 80, "cc": 110}
AGREE_MIN = 0.995
CALIB_BATCHES, CALIB_BATCH = 8, 4
REMAT_BATCH = 16
# The CLI's static int8 runs calibrate on phase 9's two train batches.
INT8_STATIC_FLAGS = ["--quantized", "--quant_mode", "static", "--calib_batches", "2"]


def int8_counts(fb, quant):
    return {**fused_counts(fb), "int8_matmul": quant.int8_matmul.launches}


def reset_int8_counts(fb, quant):
    reset_counts(fb)
    quant.int8_matmul.launches = 0


def confident_agreement(p_ref, p_got):
    """(share of confident pixels, share of them where the decisions agree):
    binary heads confident where |p - 0.5| > 0.05 (the JAX int8 tests'
    margin), class maps where the top class leads the second by 0.1 (the
    same margin for two classes); decisions thresholded and argmaxed."""
    if p_ref.shape[-1] == 1:
        conf = np.abs(p_ref[..., 0] - 0.5) > 0.05
        agree = (p_ref[..., 0] > 0.5) == (p_got[..., 0] > 0.5)
    else:
        top = np.sort(p_ref, -1)
        conf = top[..., -1] - top[..., -2] > 0.1
        agree = p_ref.argmax(-1) == p_got.argmax(-1)
    return float(conf.mean()), float(agree[conf].mean()) if conf.any() else float("nan")


def int8_gemm_checks(quant, dev, seed, shapes):
    """``int8_matmul`` at every (rows, K, N, rows per sample) of a forward
    on random int8 operands, against the fp64 product of the same operands
    on the card (exact: every partial sum is an integer below 2^53)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    checked = []
    for m, k, n, per_sample in sorted(shapes):
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w = quant.prepare_weight(torch.randn(k, n, generator=gen, device=dev))
        got = quant.int8_matmul(xq, w, rows_per_sample=per_sample)
        want = xq.double() @ w.q[:k, :n].double()
        if got.dtype != torch.int32 or not torch.equal(got.double(), want):
            raise AssertionError(f"int8_matmul at M={m} K={k} N={n} differs from the product")
        checked.append([m, k, n])
    return checked


def remat_step(model, data, dtype):
    """One train step (lr 2e-4): loss, gradients, BN running stats."""
    from change3d_tpu_torch.train.engine import train_step
    from change3d_tpu_torch.train.optim import torch_adam

    opt = torch_adam(model.parameters(), weight_decay=1e-4)
    loss = float(train_step(model, opt, lambda _: 2e-4, data, 0, compute_dtype=dtype)["loss"])
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    stats = {n: b.detach().clone() for n, b in model.named_buffers()
             if n.endswith((".mean", ".var"))}
    return loss, grads, stats


def pointwise_site_ms(quant, dev, seed, sites):
    """Over one BCD int8 forward's pointwise sites (``sites``: batch, rows
    per sample, K, N of each, 80), on bf16 activations at those shapes:
    summed CUDA-event ms of the dynamic int8 site (quantise, product,
    rescale), of its int8 product alone, and of the bf16 matmul that the
    unquantised plain path runs there; the quantise and rescale passes are
    the difference of the first two."""
    from change3d_tpu_torch.ops.layers import pointwise_conv3d

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"sites": len(sites), "int8_site_ms": 0.0, "int8_gemm_ms": 0.0, "bf16_matmul_ms": 0.0}
    for b, rows, k, n in sites:
        x = torch.randn(b, rows, k, generator=gen, device=dev).to(torch.bfloat16)
        w32 = torch.randn(k, n, generator=gen, device=dev)
        w = quant.prepare_weight(w32)
        xq = quant.quantize_act(x)[0].reshape(-1, k)
        out["int8_site_ms"] += event_ms(lambda: quant.pointwise_conv3d_int8(x, w), 5)
        out["int8_gemm_ms"] += event_ms(lambda: quant.int8_matmul(xq, w, rows_per_sample=rows), 5)
        out["bf16_matmul_ms"] += event_ms(lambda: pointwise_conv3d(x, w32), 5)
    out["quantise_rescale_ms"] = out["int8_site_ms"] - out["int8_gemm_ms"]
    return out


def remat_models(dev, seed, remats):
    """BCD models at full width, one per remat flag, from one seeded state,
    and a seeded batch of REMAT_BATCH 256² pairs on the card."""
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import x3d_l_config

    data = train_batch(np.random.RandomState(seed + 21), REMAT_BATCH, 256, dev)
    state = Change3D(Task.BCD, device=dev, seed=seed + 21).state_dict()
    models = {}
    for remat in remats:
        models[remat] = Change3D(Task.BCD, backbone_cfg=x3d_l_config(remat=remat), device=dev)
        models[remat].load_state_dict(state)
    return models, data


def remat_parity(dev, seed):
    """One fp32 (TF32 off) BCD train step at batch 16, 256², with and without
    remat from the same state: loss and gradients within 1e-5 relative in
    the 2-norm, BN running stats within 1e-6 (moved once)."""
    runs = {}
    for remat in (False, True):
        models, data = remat_models(dev, seed, (remat,))
        runs[remat] = remat_step(models[remat], data, None)
        del models, data
        torch.cuda.empty_cache()
    (loss, grads, bn), (loss_r, grads_r, bn_r) = runs[False], runs[True]
    norm = lambda ts: math.sqrt(sum(float(t.double().norm()) ** 2 for t in ts))
    grad_rel = norm(grads_r[k] - g for k, g in grads.items()) / norm(grads.values())
    bn_err = max(float((bn_r[k] - v).abs().max()) for k, v in bn.items())
    loss_rel = abs(loss_r - loss) / abs(loss)
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-5 and bn_err <= 1e-6
            and grads.keys() == grads_r.keys()):
        raise AssertionError(f"remat step: loss rel {loss_rel}, gradients rel {grad_rel}, "
                             f"BN stats max |d| {bn_err}")
    return {"fp32_loss_rel": loss_rel, "fp32_grad_rel_2norm": grad_rel,
            "fp32_bn_stats_max_abs_err": bn_err, "batch": REMAT_BATCH}


def remat_times(dev, seed, card):
    """bf16 (the CLI's) BCD train steps at batch 16, 256², without and with
    remat in turns: ms per step (CUDA events) and peak memory; the remat
    peak must be the lower."""
    from change3d_tpu_torch.train.engine import train_step
    from change3d_tpu_torch.train.optim import torch_adam

    models, data = remat_models(dev, seed, (False, True))
    opts = {remat: torch_adam(m.parameters(), weight_decay=1e-4) for remat, m in models.items()}
    step = lambda remat: train_step(models[remat], opts[remat], lambda _: 2e-4, data, 0,
                                    compute_dtype=torch.bfloat16)
    stats, times = {"card": card}, {False: [], True: []}
    for remat in (False, True, True, False):
        step(remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times[remat].append(event_ms(lambda: step(remat), 1))
        stats[f"peak_gib_{'remat' if remat else 'plain'}"] = (torch.cuda.max_memory_allocated()
                                                               / 2 ** 30)
    stats["bf16_ms_per_step_plain"], stats["bf16_ms_per_step_remat"] = times[False], times[True]
    if not stats["peak_gib_remat"] < stats["peak_gib_plain"]:
        raise AssertionError(f"remat peak {stats['peak_gib_remat']} GiB is not below "
                             f"{stats['peak_gib_plain']} GiB")
    return stats


def phase_quant(fb, dev, seed, tmp, bcd_loop, card, batch):
    """int8 and remat on the card, at full X3D-L width, 256², bf16. A
    ``cli export --quantized --quant_mode static`` of phase 9's BCD run
    starts first, in a subprocess. Then, for BCD, SCD and BDA, the int8
    model with the fused model's weights, dynamic and calibrated static:
    ``predict_u8`` with the counts set to 0 just before (0 + 0 fused
    launches, 80 int8 products per forward), the confident-pixel agreement
    of its bf16 maps with the fused bf16 model's (>= AGREE_MIN), and every
    int8 product's shape held exactly against the fp64 product; CC's
    ``caption_u8`` with a dynamic int8 encoder at beam 1 (110 products);
    ``cli predict --quantized --quant_mode static`` PNGs byte-equal to a
    direct static Predictor; the remat step's fp32 parity; once the export
    is done, the artifact's masks equal to that Predictor's; then, with
    nothing else on the card, pairs/s and device ms of the int8 forwards
    beside the fused and the plain (unfused) bf16 ones in turns, the int8
    GEMM's share of a forward, the int8 pointwise sites' ms split into the
    product and the quantise / rescale passes beside bf16 matmuls, and the
    remat step's bf16 ms and peak memory in turns."""
    t_start = time.perf_counter()
    artifact = os.path.join(tmp, "bcd_int8_static.pt2")
    export_job = start_cli(["export", "--model_task", "bcd", "--checkpoint", bcd_loop["run_dir"],
                            "--out", artifact, "--file_root", bcd_loop["file_root"],
                            "--calib_batch_size", str(TRAIN_BATCH["bcd"]), *INT8_STATIC_FLAGS],
                           artifact + ".log")
    try:
        stats = quant_checks(fb, dev, seed, tmp, bcd_loop, card, batch, export_job, artifact)
    finally:
        if export_job.poll() is None:
            export_job.kill()
            export_job.wait()
    stats["seconds"] = time.perf_counter() - t_start
    print(f"int8 and remat phase: {stats['seconds']:.1f} s", flush=True)
    return stats


def quant_checks(fb, dev, seed, tmp, bcd_loop, card, batch, export_job, artifact):
    """Phase 13's checks and times, beside the running ``export_job``."""
    from change3d_tpu_torch import cli
    from change3d_tpu_torch.data.datasets import DATASETS
    from change3d_tpu_torch.data.pipeline import DataLoader, pair_collate
    from change3d_tpu_torch.data.png import encode_png_bytes
    from change3d_tpu_torch.data.transforms import make_transform_pipelines
    from change3d_tpu_torch.export import load_exported
    from change3d_tpu_torch.inference import CaptionPredictor, Predictor, calibrate_quant_scales
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import x3d_l_config
    from change3d_tpu_torch.ops import quant
    from change3d_tpu_torch.serving import masks_to_arrays
    from change3d_tpu_torch.train import loop

    run, root = bcd_loop["run_dir"], bcd_loop["file_root"]
    batch16 = TRAIN_BATCH["bcd"]
    stats = {"card": card, "batch": batch, "tasks": {}}
    rs = np.random.RandomState(seed + 13)
    norm = lambda a: (a.astype(np.float32) / 255.0 - 0.5) / 0.5
    shapes, sites = set(), {}
    real_product = quant._rescaled_product

    def recording(x, xq, xs, w):
        rows = math.prod(x.shape[1:-1])
        shapes.add((x.shape[0] * rows, x.shape[-1], w.n, rows))
        recording.sites.append((x.shape[0], rows, x.shape[-1], w.n))
        return real_product(x, xq, xs, w)

    preds = {}
    for task in TASKS:
        kw = dict(num_classes=NUM_CLASSES[task], device=dev, seed=seed + 14)
        fused = Change3D(Task(task), **kw)
        pairs = tuple(rs.randint(0, 256, (batch, 256, 256, 3)).astype(np.uint8) for _ in range(2))
        calib = [tuple(norm(rs.randint(0, 256, (CALIB_BATCH, 256, 256, 3)).astype(np.uint8))
                       for _ in range(2)) for _ in range(CALIB_BATCHES)]
        p_ref = Predictor(fused, device=dev).predict_probs(norm(pairs[0]), norm(pairs[1]))
        row = {}
        for mode in ("dynamic", "static"):
            model = Change3D(Task(task), backbone_cfg=x3d_l_config(quantized_eval=True,
                                                                   quant_mode=mode), **kw)
            model.load_state_dict(fused.state_dict())
            if mode == "static":
                t0 = time.perf_counter()
                calibrate_quant_scales(model, calib)
                torch.cuda.synchronize()
                row["calibrate_s"] = time.perf_counter() - t0
            pred = Predictor(model, device=dev)
            pred.predict_u8(*pairs)  # quantise the weights, warm the allocator
            reset_int8_counts(fb, quant)
            recording.sites = sites.setdefault((task, mode), [])
            quant._rescaled_product = recording  # notes each product's shape
            try:
                maps = pred.predict_u8(*pairs)
                torch.cuda.synchronize()
            finally:
                quant._rescaled_product = real_product
            launches = int8_counts(fb, quant)
            want = {"fused_block_fwd": 0, "fused_block_se_sums": 0,
                    "int8_matmul": INT8_PER_FORWARD[task]}
            if launches != want:
                raise AssertionError(f"{task} {mode} int8 forward launches {launches}, want {want}")
            p_got = pred.predict_probs(norm(pairs[0]), norm(pairs[1]))
            heads = {}
            for key in p_ref:
                share, agree = confident_agreement(p_ref[key], p_got[key])
                if not (np.isfinite(p_got[key]).all() and agree >= AGREE_MIN):
                    raise AssertionError(f"{task} {mode} {key}: {agree} of confident pixels "
                                         f"agree with the fused bf16 model, want {AGREE_MIN}")
                heads[key] = {"confident_share": share, "agreement": agree,
                              "hard_agreement_all": float(
                                  (Predictor.harden({key: p_got[key]})[key]
                                   == Predictor.harden({key: p_ref[key]})[key]).mean())}
            if set(maps) != set(p_ref):
                raise AssertionError(f"{task} {mode} heads {sorted(maps)}")
            row[mode] = {"launches": launches, "heads": heads}
            preds[(task, mode)] = pred
        preds[(task, "fused")] = Predictor(fused, device=dev)
        plain = Change3D(Task(task), backbone_cfg=x3d_l_config(fused_inference=False), **kw)
        plain.load_state_dict(fused.state_dict())
        preds[(task, "plain")] = Predictor(plain, device=dev)
        stats["tasks"][task] = row
        print(f"int8 {task} ({card}): {json.dumps(row)}", flush=True)
    stats["gemm_shapes"] = int8_gemm_checks(quant, dev, seed + 16, shapes)
    print(f"int8 GEMM exact against the fp64 product at {len(shapes)} shapes "
          f"(K, N): {sorted({(k, n) for _, k, n, _ in shapes})}", flush=True)

    # CC: the int8 encoder at beam 1.
    cc = Change3D(Task.CC, backbone_cfg=x3d_l_config(quantized_eval=True), vocab_size=CC_VOCAB,
                  device=dev, seed=seed + 15)
    cc_pred = CaptionPredictor(cc, cc_words(), beam_size=1, device=dev)
    cc_pairs = tuple(rs.randint(0, 256, (batch, 256, 256, 3)).astype(np.uint8) for _ in range(2))
    cc_pred.caption_u8(*cc_pairs)
    reset_int8_counts(fb, quant)
    captions = cc_pred.caption_u8(*cc_pairs)
    torch.cuda.synchronize()
    launches = int8_counts(fb, quant)
    want = {"fused_block_fwd": 0, "fused_block_se_sums": 0, "int8_matmul": INT8_PER_FORWARD["cc"]}
    if launches != want or len(captions) != batch or not all(isinstance(c, str) for c in captions):
        raise AssertionError(f"cc int8 caption_u8: launches {launches}, want {want}")
    stats["cc"] = {"launches": launches, "captions": len(captions)}
    del cc, cc_pred

    # The CLI on phase 9's BCD run: static predict, then the static artifact.
    out = os.path.join(tmp, "int8_masks")
    reset_int8_counts(fb, quant)
    rc, _ = cli_quiet(cli, ["predict", "--model_task", "bcd", "--checkpoint", run, "--file_root",
                            root, "--out", out, *INT8_STATIC_FLAGS])
    launches = int8_counts(fb, quant)
    n_test = batch16  # phase 9's test split: one batch of 16
    if rc != 0 or launches != {"fused_block_fwd": 0, "fused_block_se_sums": 0,
                               "int8_matmul": INT8_PER_FORWARD["bcd"]}:
        raise AssertionError(f"cli predict --quantized static rc {rc}, launches {launches}")
    cfg = loop.RunConfig(file_root=root, batch_size=batch16, quantized=True, quant_mode="static",
                         calib_batches=2, device="cuda")
    model = loop.build_model(cfg)
    model.load_state_dict(torch.load(os.path.join(run, "best", "model.pt"), map_location=dev))
    loop.calibrate_from_train_split(cfg, model)
    pred = Predictor(model, device=dev)
    _, eval_tf = make_transform_pipelines("bcd", 256, 256)
    ds = DATASETS["bcd"](root, "test", eval_tf)
    names = [os.path.splitext(os.path.basename(p))[0] for p in ds.pre_images]
    idx, float_batch = 0, None
    for b in DataLoader(ds, batch16, num_workers=2, collate=pair_collate, pad_final=True):
        valid = b.pop("valid")
        float_batch = float_batch or (b["pre"], b["post"])
        maps = pred.predict(b["pre"], b["post"])["change"]
        for i in np.flatnonzero(valid):
            with open(os.path.join(out, f"{names[idx]}.png"), "rb") as f:
                if f.read() != encode_png_bytes(masks_to_arrays("bcd", {"change": maps[i]})[
                        "change"]):
                    raise AssertionError(f"cli predict --quantized mask {names[idx]} differs")
            idx += 1
    if idx != n_test:
        raise AssertionError(f"cli predict --quantized wrote {idx} masks, want {n_test}")
    del model
    stats["remat"] = remat_parity(dev, seed)  # while the export may still run
    t0 = time.perf_counter()
    export_job.wait(timeout=600)
    stats["export_wait_s"] = time.perf_counter() - t0
    if export_job.returncode != 0:
        with open(artifact + ".log") as f:
            raise AssertionError(f"cli export --quantized static failed:\n{f.read()[-4000:]}")
    fn = load_exported(artifact, dev)
    n_mm = sum(1 for n in fn.program.graph.nodes if n.target == torch.ops.aten._int_mm.default)
    got = fn(*float_batch)["change"].float().cpu().numpy() > 0.5
    want = pred.predict(*float_batch)["change"]
    if n_mm != INT8_PER_FORWARD["bcd"] or not np.array_equal(got[..., 0], want):
        raise AssertionError(f"static int8 artifact: {n_mm} int8 products, masks equal "
                             f"{np.array_equal(got[..., 0], want)}")
    stats["cli"] = {"predict_static_byte_equal_pngs": idx, "predict_launches": launches,
                    "artifact_int8_products": n_mm, "artifact_bytes": os.path.getsize(artifact),
                    "artifact_masks_equal": True}
    print(f"int8 CLI: {json.dumps(stats['cli'])}", flush=True)
    del pred, fn

    # Times, with nothing else on the card: BCD in turns; device ms of every task's three forwards.
    pairs = [tuple(rs.randint(0, 256, (batch, 256, 256, 3)).astype(np.uint8) for _ in range(2))
             for _ in range(2)]
    kinds = ("fused", "plain", "dynamic", "static")
    runs = {k: [] for k in kinds}
    for kind in kinds + kinds[::-1]:
        runs[kind].append(pairs_per_s(preds[("bcd", kind)], pairs, batch))
    dev_pairs = tuple(torch.from_numpy(a).to(dev) for a in pairs[0])
    fwd_ms = {task: {k: event_ms(lambda: preds[(task, k)].predict_u8_device(*dev_pairs), 3)
                     for k in kinds} for task in TASKS}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    gemm = {}
    for kind in ("dynamic", "static"):
        with torch.profiler.profile(activities=acts) as prof:
            preds[("bcd", kind)].predict_u8_device(*dev_pairs)
            torch.cuda.synchronize()
        total = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        mm = sum(e.device_time_total for e in prof.key_averages() if e.key == "aten::_int_mm")
        gemm[kind] = {"int8_gemm_ms": mm / 1e3, "device_ms": total / 1e3,
                      "share": mm / total if total else float("nan")}
    stats["times"] = {"bcd_pairs_per_s": runs, "forward_ms": fwd_ms, "int8_gemm": gemm,
                      "bcd_pointwise_sites": pointwise_site_ms(quant, dev, seed + 17,
                                                               sites[("bcd", "dynamic")]),
                      "turns": "fused, plain, dynamic, static, static, dynamic, plain, fused"}
    for kind in kinds:
        print(f"bcd predict_u8 bf16 256^2 batch {batch} {kind}: {runs[kind]} pairs/s, "
              f"{fwd_ms['bcd'][kind]} ms per forward on the device ({card})", flush=True)
    print(f"int8 forward times ({card}): {json.dumps(stats['times'])}", flush=True)
    del preds
    torch.cuda.empty_cache()
    stats["remat"].update(remat_times(dev, seed, card))
    print(f"remat: BCD train step, batch {REMAT_BATCH}, 256² ({card}): "
          f"{json.dumps(stats['remat'])}", flush=True)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8, help="pairs per forward for the timings")
    ap.add_argument("--batches", type=int, default=3, help="forwards in the launch-count run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "chip_smoke.json"))
    ap.add_argument("--int8-only", action="store_true",
                    help="build the kernels and run phase 13 alone (on a fresh cli bcd run)")
    ap.add_argument("--multi-gpu-only", action="store_true",
                    help="build the kernels and run phase 12 alone, on every card")
    ap.add_argument("--data-only", action="store_true",
                    help="build the kernels and run the data phase and phase 9's cli cc alone")
    ap.add_argument("--classify-only", action="store_true",
                    help="build the kernels and run phase 15 (the Kinetics classifiers) alone")
    ap.add_argument("--kinetics-only", action="store_true",
                    help="build the kernels and run phase 16 (X3D-L, 16 x 312^2, B = 30) alone")
    ap.add_argument("--depthwise-only", action="store_true",
                    help="build the kernels and run the depthwise kernel's checks, launch "
                         "counts and timings alone")
    ap.add_argument("--rank-worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.rank_worker:
        return rank_worker(args.rank_worker)
    from change3d_tpu_torch.device import resolve_device
    from change3d_tpu_torch.inference import Predictor
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import x3d_l_config
    from change3d_tpu_torch.ops import cuda_build
    from change3d_tpu_torch.ops import depthwise_conv as dwc
    from change3d_tpu_torch.ops import fused_block as fb
    from change3d_tpu_torch.ops import repros as rp
    from change3d_tpu_torch.train.optim import torch_adam

    dev = resolve_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    reports = cuda_build.build()
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"build: {sorted(cuda_build.SIGNATURES)} in {time.perf_counter() - t0:.1f} s (nvcc "
          f"for the .cu kernels and c++ for meteor.cpp, started together)", flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    if args.multi_gpu_only:
        return multi_gpu_only(fb, dev, args, card)
    if args.int8_only:
        return int8_only(fb, dev, args, card)
    if args.data_only:
        return data_only(fb, dev, args, card)
    if args.classify_only:
        return classify_only(fb, dev, args, card)
    if args.kinetics_only:
        return kinetics_only(fb, dwc, dev, args, card)
    if args.depthwise_only:
        return depthwise_only(dwc, dev, args, card)

    seeds = list(range(args.seed, args.seed + KERNEL_SEEDS))
    worst = phase_kernels(fb, dev, seeds, args.batch)
    phase_depthwise(dwc, dev, seeds, args.batch, worst)
    pkg = (fb, Change3D, Task, Predictor, x3d_l_config)
    serving = {task: phase_forward(pkg, dev, task, args.batch, args.batches, args.seed)
               for task in TASKS}
    repro_worst, repro_launches = phase_repros(rp, dev, seeds)
    times = {}
    for task in TASKS:
        pred, plain_pred, pairs, _, _ = serving[task]
        times[task] = serving_times(pred, plain_pred, pairs, args.batch, dev)
    launches = {task: serving[task][3] for task in TASKS}
    forward_check = {task: serving[task][4] for task in TASKS}
    del serving, pred, plain_pred, pairs
    torch.cuda.empty_cache()
    dw_forwards = phase_depthwise_forwards(dwc, dev, args.seed, DW_BATCH)
    cc_model, cc_preds, cc_pairs, cc_launches, forward_check["cc"] = phase_cc_forward(
        fb, dev, args.batch, args.seed)
    cc_times = phase_cc_times(cc_preds, cc_pairs, args.batch, dev, card)
    del cc_model, cc_preds, cc_pairs
    torch.cuda.empty_cache()
    rows = kernel_rows(fb, worst, args.batch, dev, args.seed, card)
    dw_rows, dw_timed = depthwise_rows(dwc, dev, args.seed, card)
    rows += dw_rows
    rows += repro_rows(rp, dev, args.seed, card)
    classify, classify_rows_ = phase_classify(fb, dev, worst, args.seed, card)
    rows += classify_rows_
    kinetics, kinetics_rows = phase_kinetics(fb, dwc, dev, worst, args.seed, card)
    rows += kinetics_rows

    train = {"parity": {task: phase_train_parity(dev, args.seed, task) for task in TASKS}}
    train["parity"]["cc"] = phase_cc_train_parity(dev, args.seed)
    model, opt, data, train["overfit_losses"] = phase_overfit(dev, args.seed)
    train["times"] = {"bcd": phase_train_times(model, opt, data, card)}
    del model, opt, data
    for task in ("scd", "bda"):
        model = Change3D(Task(task), num_classes=NUM_CLASSES[task], device=dev, seed=args.seed)
        opt = torch_adam(model.parameters(), weight_decay=1e-4)
        data = train_batch(np.random.RandomState(args.seed + 2), TRAIN_BATCH[task], 256, dev, task)
        train["times"][task] = phase_train_times(model, opt, data, card)
        del model, opt, data
    train["times"]["cc"] = phase_cc_train_times(dev, args.seed, card)
    with tempfile.TemporaryDirectory() as deploy_dir:
        loops = {task: phase_train_loop(fb, args.seed, task,
                                        keep=os.path.join(deploy_dir, "bcd_loop")
                                        if task == "bcd" else None)
                 for task in TASKS}
        loops["cc"] = phase_cc_loop(fb, args.seed, keep=os.path.join(deploy_dir, "cc_loop"))
        train["loop"] = {task: loop[1] for task, loop in loops.items()}
        data = phase_data(args.seed, deploy_dir, card)
        t0 = time.perf_counter()
        deploy_model, deploy = phase_deploy_files(fb, dev, args.seed, deploy_dir,
                                                  loops["bcd"][1])
        deploy["serve"] = phase_deploy_serve(fb, dev, deploy_model, args.seed, card)
        deploy["seconds"] = time.perf_counter() - t0
        del deploy_model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        export = phase_export(fb, dev, args.seed, deploy_dir, loops["bcd"][1], loops["cc"][1],
                              card)
        export["seconds"] = time.perf_counter() - t0
        multi_gpu = phase_multi_gpu(fb, dev, args.seed, deploy_dir,
                                    loops["bcd"][1]["file_root"], loops["cc"][1]["file_root"])
        quant = phase_quant(fb, dev, args.seed, deploy_dir, loops["bcd"][1], card, args.batch)
    print(f"deploy phase: {deploy['seconds']:.1f} s", flush=True)
    print(f"export phase: {export['seconds']:.1f} s", flush=True)
    print(f"multi-GPU phase: {multi_gpu['seconds']:.1f} s", flush=True)
    print(f"int8 and remat phase: {quant['seconds']:.1f} s", flush=True)
    print(f"data phase: {data['seconds']:.1f} s", flush=True)
    print(f"classify phase: {classify['seconds']:.1f} s", flush=True)
    print(f"kinetics phase: {kinetics['seconds']:.1f} s", flush=True)
    print(f"kernels vs plain versions, worst over every check: {json.dumps(worst)}", flush=True)
    for task in TASKS:
        runs, fwd_ms = times[task]
        for kind in ("fused", "plain"):
            print(f"{task} predict_u8 bf16 256^2 batch {args.batch} {kind} blocks: "
                  f"{runs[kind]} pairs/s end to end, {fwd_ms[kind]} ms per forward on the "
                  f"device ({card})", flush=True)
    for name, _, _ in CLASSIFY:
        c = classify[name]
        for kind in ("fused", "plain"):
            print(f"{name} classify bf16 {c['frames']}x{c['side']}^2 batch {c['batch']} {kind} "
                  f"blocks: {c['clips_per_s'][kind]} clips/s end to end, {c['forward_ms'][kind]} "
                  f"ms per forward on the device ({card})", flush=True)
    print(f"{KINETICS[0]} classify_u8 bf16 {KINETICS[2]}x{KINETICS[3]}^2 batch {KINETICS[1]} "
          f"fused blocks: {kinetics['clips_per_s']} clips/s end to end, "
          f"{kinetics['forward_ms']} ms per forward on the device ({card})", flush=True)
    for beam, row in cc_times.items():
        print(f"cc caption_u8 bf16 256^2 batch {args.batch} beam {beam}: "
              f"{row['captions_per_s']} captions/s end to end, encoder {row['encoder_ms']} ms, "
              f"decode {row['decode_ms']} ms over {row['decode_steps']} steps "
              f"({row['decode_host_ms_per_step']} host ms per step, "
              f"{row['decode_device_busy_ms']} ms device-busy) ({card})", flush=True)

    kernels = []
    for kernel, replaces in (("fused_block_fwd", f"{PALLAS}:414 (also :216, :365)"),
                             ("fused_block_se_sums", f"{PALLAS}:199 (also :349)")):
        worst_of = lambda dtype, k: max(w[dtype][k] for w in worst[kernel].values())
        forwards = {task: per_forward(rows, kernel, CLIP_T[task], args.batch) for task in TASKS}
        forwards["cc"] = per_forward(rows, kernel, 3, args.batch, "launches_per_cc_forward")
        forwards["cc_batch32"] = per_forward(rows, kernel, 3, CC_BATCH, "launches_per_cc_forward")
        for name, t, _ in CLASSIFY:
            forwards[name] = per_forward(rows, kernel, t, CLASSIFY_BATCH, model=name)
        forwards[KINETICS[0]] = kinetics["per_forward"][kernel]
        shapes = [{k: r[k] for k in ("model", "stage", "shape", "tt", "tile", "chunk",
                                     "launches_per_forward", "ms", "plain_ms", "bound_ms",
                                     "bound_by")}
                  for r in rows if r["kernel"] == kernel and r.get("model")]
        kernels.append({
            "name": kernel, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches["bcd"][kernel],
            "launches_scd_forward": launches["scd"][kernel],
            "launches_bda_forward": launches["bda"][kernel],
            "launches_cc_forward": cc_launches[1][kernel],
            "launches_classify_forward": {**{name: classify[name]["launches"][kernel]
                                             for name, _, _ in CLASSIFY},
                                          KINETICS[0]: kinetics["launches"][kernel]},
            "launches_per_forward": forwards["bcd"]["launches_per_forward"],
            "launches_train_loop": {task: loop[0][kernel] for task, loop in loops.items()},
            "launches_deploy": {
                "cli_predict_2_batches": deploy["convert_predict"]["launches"][kernel],
                "tiled_scene": deploy["tiled"]["launches"][kernel],
                "served_bcd_batches": deploy["serve"]["agreement"]["launches"][kernel],
                "served_load": deploy["serve"]["load"]["launches"][kernel],
                "served_cc_batches": deploy["serve"]["cc"]["launches"][kernel]},
            "launches_export": {
                **{f"artifact_forward_b{b}": export["bcd"][str(b)]["launches"][kernel]
                   for b in EXPORT_BATCHES},
                "cpu_exported_b8": export["bcd_cpu_b8"]["launches"][kernel],
                **{f"cc_artifact_beam{k}": export["cc"][str(k)]["launches"][kernel]
                   for k in EXPORT_BEAMS},
                "served_artifact_batches": export["served"]["launches"][kernel]},
            "launches_multi_gpu": {
                "cli_bcd_per_process": [c[kernel] for c in multi_gpu["bcd"]["launches"]],
                "cli_cc_per_process": [c[kernel] for c in multi_gpu["cc"]["launches"]],
                "shard_predictor_batch": multi_gpu["shard"]["launches"][kernel]},
            "max_abs_err": worst_of("bfloat16", "max_abs_err"),
            "limit_used": worst_of("bfloat16", "limit_used"),
            "max_abs_err_fp32": worst_of("float32", "max_abs_err"),
            "limit_used_fp32": worst_of("float32", "limit_used"),
            "worst_by_t": worst[kernel],
            "ms": forwards["bcd"]["ms"], "plain_ms": forwards["bcd"]["plain_ms"],
            "bound_ms": forwards["bcd"]["bound_ms"], "bound_by": forwards["bcd"]["bound_by"],
            "library_ms": None, "per_forward": forwards, "classify_shapes": shapes,
            "per": f"one bf16 BCD forward (T=3) at batch {args.batch}, summed over its launches; "
                   f"per_forward gives SCD (T=5), BDA (T=4), CC (T=3, stages 1-4, at batch "
                   f"{args.batch} and {CC_BATCH}) and the X3D-M / S / XS classifiers (T=16, 13, "
                   f"4 at batch {CLASSIFY_BATCH}) and X3D-L's Kinetics classifier (T=16 at "
                   f"312^2, batch {KINETICS[1]}) too; classify_shapes their shapes, T-tiles "
                   f"(tt) and times",
        })
    dw_worst = lambda dtype, k: max(w[dtype][k] for w in worst["depthwise_conv3d"].values()
                                    if dtype in w)
    dw_per_forward = depthwise_per_forward(rows)
    dw_per_forward[KINETICS[0]] = kinetics["per_forward"]["depthwise_conv3d"]
    kernels.append({
        "name": "depthwise_conv3d", "route": "cuda", "source": DW_SOURCE,
        "replaces": "none: an XLA conv on the TPU (change3d_tpu/ops/layers.py:depthwise_conv3d); "
                    "on the card it replaces cuDNN's grouped conv3d",
        "launches": dw_forwards["launches_per_forward"]["bcd"],
        "launches_per_forward": dw_forwards["launches_per_forward"],
        "max_abs_err": dw_worst("bfloat16", "max_abs_err"),
        "limit_used": dw_worst("bfloat16", "limit_used"),
        "max_abs_err_fp32": dw_worst("float32", "max_abs_err"),
        "limit_used_fp32": dw_worst("float32", "limit_used"),
        "worst_by_t": worst["depthwise_conv3d"], "timed_operands": dw_timed,
        "ms": dw_per_forward["bcd"]["ms"], "plain_ms": dw_per_forward["bcd"]["plain_ms"],
        "bound_ms": dw_per_forward["bcd"]["bound_ms"], "bound_by": "bytes",
        "library_ms": dw_per_forward["bcd"]["library_ms"], "per_forward": dw_per_forward,
        "bcd_profiled": dw_forwards["bcd_profiled"],
        "per": f"one bf16 BCD forward (T=3) at batch {DW_BATCH}, summed over its launches; "
               f"per_forward gives SCD, BDA, CC, the int8 (unfused) BCD and CC, X3D-M and "
               f"X3D-L's Kinetics classifier (batch {KINETICS[1]}); "
               f"library_ms is cuDNN's F.conv3d(groups=C) on [B, C, T, H, W], "
               f"relayout_library_ms the same with the relayouts to and from it; rows give "
               f"every shape, X3D-M's included",
    })
    for kernel, replaces in (("dot_1d", f"{REPRO_PALLAS}:25 (pallas_call :35)"),
                             ("manual_dma", f"{REPRO_PALLAS}:39 (pallas_call :48)")):
        row = next(r for r in rows if r["kernel"] == kernel)
        kernels.append({
            "name": kernel, "route": "cuda", "source": REPRO_SOURCE, "replaces": replaces,
            "launches": repro_launches[kernel],
            "max_abs_err": repro_worst[kernel]["max_abs_err"],
            "limit_used": repro_worst[kernel]["limit_used"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "ms_events": row["ms_events"], "plain_over_ms": row["plain_over_ms"],
            "library_over_ms": row["library_over_ms"],
            "per": f"one launch at {row['shape']}; ms, plain_ms and library_ms on the device "
                   f"timeline (torch.profiler), ms_events by CUDA events around launches",
        })

    detail = {"card": card, "torch": torch.__version__, "batch": args.batch,
              "pairs_per_s": {task: times[task][0] for task in TASKS},
              "forward_ms": {task: times[task][1] for task in TASKS},
              "forward_check": forward_check, "cc_times": cc_times, "classify": classify,
              "kinetics": kinetics,
              "depthwise_forwards": dw_forwards,
              "rows": rows,
              "kernels": kernels, "train": train, "deploy": deploy, "export": export,
              "multi_gpu": multi_gpu, "quant": quant, "data": data}
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(detail, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
