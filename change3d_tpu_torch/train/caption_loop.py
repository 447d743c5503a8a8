"""Change-captioning training with per-epoch beam-search evaluation
(counterpart of ``change3d_tpu/train/caption_loop.py``).

The reference protocol, as the JAX loop runs it:

- teacher-forced caption CE (padding ignored), gradient values clipped to
  +-5, coupled decay 1e-5, Adam(0.9, 0.99); a separate encoder learning
  rate when ``encoder_lr`` differs from ``lr``, or a frozen encoder
  (``fine_tune_encoder=False``);
- the learning rate halved every 10 epochs;
- evaluation after every epoch (epoch 0 included) on one caption row per
  image (every 5th, ``_EveryFifth``): the fused-block encoder in fp32, beam
  search, <start>/<end>/<pad> stripped, BLEU-1..4 / METEOR / ROUGE-L /
  CIDEr-D and the change / no-change split by the canned no-change
  sentences; ``res.json`` / ``gts.json`` written;
- the best checkpoint gated on BLEU-4, the latest two kept, and a final
  re-evaluation of the best weights.

``pretrained`` starts the backbone from a Kinetics ``X3D_L.pyth``;
``run_caption_eval`` scores a saved run (best or latest weights) on any
split.

SIGTERM is honoured between steps (``PreemptionGuard``): the loop saves the
model, optimizer and step, and ``resume`` re-enters that epoch skipping the
batches already trained. Dropout draws from a generator re-seeded from
(seed, step) before each step, so a preempted-and-resumed run ends
bit-for-bit where an uninterrupted one does. A preemption on an epoch's last
step leaves it unevaluated; the resumed run evaluates it first.

Under a process group the loop runs as the detection loop does
(``train/loop.py``): global batches rounded to the world size, sharded
loaders, the global step, process 0 writing, agreement on SIGTERM. The
dropout generator is seeded alike on every process and draws at the global
batch's shape (``ops/attention.dropout``), so N processes train as one does
with dropout on. Each process decodes its slice of every evaluation batch;
the hypotheses and references are gathered to every process and put back in
the single-process order, so every process scores the same set and the
BLEU-4 gate agrees.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from change3d_tpu_torch.checkpoint.io import CheckpointManager
from change3d_tpu_torch.data.datasets import CaptionDataset
from change3d_tpu_torch.data.pipeline import caption_collate, device_prefetch, make_data_loader
from change3d_tpu_torch.device import resolve_device
from change3d_tpu_torch.inference import CaptionPredictor
from change3d_tpu_torch.metrics.caption import eval_caption_scores
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.parallel import distributed
from change3d_tpu_torch.train.engine import train_step
from change3d_tpu_torch.train.loop import (
    _DTYPES,
    PreemptionGuard,
    _global_batch,
    load_pretrained_backbone,
    restore_run_state,
)
from change3d_tpu_torch.train.lr import shrink_schedule
from change3d_tpu_torch.train.optim import freeze_subtree, per_subtree_lr, torch_adam
from change3d_tpu_torch.utils.logging import setup_logger
from change3d_tpu_torch.utils.profiling import WindowTracer

NOCHANGE_SENTENCES = [
    "the scene is the same as before",
    "there is no difference",
    "the two scenes seem identical",
    "no change has occurred",
    "almost nothing has changed",
]


@dataclasses.dataclass
class CaptionRunConfig:
    file_root: str = ""
    dataset: str = "LEVIR_CC_5_cap_per_img_5_min_word_freq"
    word_map: Optional[str] = None
    save_dir: str = "./exp"
    epochs: int = 200
    batch_size: int = 32
    eval_batch_size: int = 32
    lr: float = 1e-4  # the decoder's (and, by default, the encoder's)
    encoder_lr: Optional[float] = None  # None: the same as lr
    weight_decay: float = 1e-5
    grad_clip: float = 5.0
    embed_dim: int = 192
    n_head: int = 8
    n_layer: int = 3
    dropout: float = 0.1
    beam_size: int = 1
    num_workers: int = 2
    loader: str = "threaded"  # or 'grain': worker processes (data/process_pipeline.py)
    seed: int = 16
    resume: bool = False
    eval_split: str = "TEST"
    fine_tune_encoder: bool = True
    compute_dtype: str = "float32"  # the train step's activations; eval runs fp32
    device: str = "cuda"
    pretrained: Optional[str] = None  # a Kinetics X3D_L.pyth for the backbone
    profile_dir: Optional[str] = None  # a torch.profiler trace of steps 10-14


def load_word_map(cfg: CaptionRunConfig) -> Dict[str, int]:
    path = cfg.word_map or os.path.join(cfg.file_root, f"WORDMAP_{cfg.dataset}.json")
    with open(path) as f:
        return json.load(f)


def build_caption_model(cfg: CaptionRunConfig, vocab_size: int, in_size: int = 256,
                        backbone_cfg=None) -> Change3D:
    """The full-width X3D-L CC model (or ``backbone_cfg``) on ``cfg.device``,
    initialised from a generator seeded with ``cfg.seed``."""
    return Change3D(Task.CC, in_height=in_size, in_width=in_size, backbone_cfg=backbone_cfg,
                    vocab_size=vocab_size, embed_dim=cfg.embed_dim, num_heads=cfg.n_head,
                    num_layers=cfg.n_layer, dropout=cfg.dropout, device=cfg.device,
                    generator=torch.Generator().manual_seed(cfg.seed))


def make_decode_fn(model: Change3D, beam_size: int, word_map: Dict[str, int]):
    """(pre, post) device tensors -> (tokens, scores) on the device: the
    model in eval mode (fused blocks on the card), fp32, KV-cached beam
    search."""
    device = next(model.parameters()).device
    pred = CaptionPredictor(model, word_map, beam_size=beam_size, compute_dtype=torch.float32,
                            device=device)

    def decode(pre: torch.Tensor, post: torch.Tensor):
        model.eval()
        return pred.caption_device(pre, post)

    return decode


def save_caption_json(save_dir: str, word_map: Dict[str, int], hypotheses, references) -> None:
    """res.json / gts.json in the reference's format (ids rendered to words)."""
    rev = {v: k for k, v in word_map.items()}
    os.makedirs(save_dir, exist_ok=True)
    res = [{"image_id": i, "caption": " ".join(rev.get(w, "?") for w in hyp)}
           for i, hyp in enumerate(hypotheses)]
    gts = [{"image_id": i, "captions": [" ".join(rev.get(w, "?") for w in r) for r in refs]}
           for i, refs in enumerate(references)]
    with open(os.path.join(save_dir, "res.json"), "w") as f:
        json.dump(res, f)
    with open(os.path.join(save_dir, "gts.json"), "w") as f:
        json.dump(gts, f)


def _allgather_caption_results(hypotheses, references, positions):
    """Every process's hypotheses and references on every process, in the
    single-process order: token lists padded into int32 arrays (-1 beyond
    a list's end), gathered in process order (``allgather_padded``),
    unpacked, and sorted by each sample's global position. Alone, the lists
    themselves."""
    if distributed.world_size() == 1:
        return hypotheses, references
    n = len(hypotheses)
    cpi = max((len(r) for r in references), default=0)
    width = max([len(h) for h in hypotheses] + [len(t) for r in references for t in r] + [1])
    hyp = np.full((n, width), -1, np.int32)
    ref = np.full((n, cpi, width), -1, np.int32)
    ref_count = np.asarray([len(r) for r in references], np.int32)
    for i, (h, refs) in enumerate(zip(hypotheses, references)):
        hyp[i, :len(h)] = h
        for j, t in enumerate(refs):
            ref[i, j, :len(t)] = t
    gathered = [distributed.allgather_padded(a) for a in
                (hyp, ref, ref_count, np.asarray(positions, np.int64))]
    rows = []
    for g_hyp, g_ref, g_count, g_pos in zip(*gathered):
        for i in range(len(g_pos)):
            rows.append((int(g_pos[i]), [int(t) for t in g_hyp[i] if t >= 0],
                         [[int(t) for t in r if t >= 0] for r in g_ref[i, :g_count[i]]]))
    rows.sort(key=lambda row: row[0])
    return [r[1] for r in rows], [r[2] for r in rows]


def evaluate_captions(model: Change3D, loader, word_map: Dict[str, int], beam_size: int = 1,
                      save_dir: Optional[str] = None, decode_fn=None) -> Dict[str, float]:
    """Batched beam-search evaluation, the caption metrics, and the change /
    no-change split. Pass one ``make_decode_fn`` per run as ``decode_fn``.
    Under a process group ``loader`` yields this process's contiguous slice
    of each global batch (the sharded ``DataLoader``); every process returns
    the scores of the whole set, and process 0 writes the JSON files."""
    rev = {v: k for k, v in word_map.items()}
    special = {word_map["<start>"], word_map["<end>"], word_map.get("<pad>", 0)}
    decode = decode_fn or make_decode_fn(model, beam_size, word_map)
    device = next(model.parameters()).device
    world, rank = distributed.world_size(), distributed.rank()
    references: List[List[List[int]]] = []
    hypotheses: List[List[int]] = []
    positions: List[int] = []
    for bi, batch in enumerate(loader):
        valid = batch.get("valid", np.ones(len(batch["pre"]), bool))
        pre, post = (torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
                     for k in ("pre", "post"))
        tokens = decode(pre, post)[0].cpu().numpy()
        b = len(tokens)
        for i in range(b):
            if not valid[i]:
                continue
            positions.append((bi * world + rank) * b + i)
            hypotheses.append([int(t) for t in tokens[i] if int(t) not in special])
            references.append([[int(t) for t in cap if int(t) not in special]
                               for cap in batch["all_captions"][i]])
    hypotheses, references = _allgather_caption_results(hypotheses, references, positions)
    if save_dir and distributed.is_primary():
        save_caption_json(save_dir, word_map, hypotheses, references)
    scores = eval_caption_scores(references, hypotheses)

    # The canned no-change sentences, compared on stripped text.
    text = lambda ids: " ".join(rev.get(i, "?") for i in ids).strip()
    ch_acc = nc_acc = n_ch = n_nc = 0
    for refs, hyp in zip(references, hypotheses):
        ref_line, hyp_line = text(refs[1] if len(refs) > 1 else refs[0]), text(hyp)
        if ref_line not in NOCHANGE_SENTENCES:
            n_ch += 1
            ch_acc += hyp_line not in NOCHANGE_SENTENCES
        else:
            n_nc += 1
            nc_acc += hyp_line in NOCHANGE_SENTENCES
    scores["change_acc"] = ch_acc / max(n_ch, 1)
    scores["nochange_acc"] = nc_acc / max(n_nc, 1)
    return scores


class _EveryFifth:
    """Eval view: one row per image, the rows with (i + 1) % cpi == 0."""

    def __init__(self, ds):
        self.ds = ds
        self.idxs = [i for i in range(len(ds)) if (i + 1) % ds.cpi == 0]

    def __len__(self) -> int:
        return len(self.idxs)

    def __getitem__(self, i, rng=None):
        return self.ds.__getitem__(self.idxs[i], rng)


def run_caption_eval(cfg: CaptionRunConfig, run_dir: Optional[str] = None,
                     split: Optional[str] = None, which: str = "best",
                     save_json: bool = False, backbone_cfg=None) -> Dict[str, float]:
    """Score a saved CC run on ``split`` (default ``cfg.eval_split``): its
    ``best`` or ``latest`` weights, one caption row per image, the fp32
    fused encoder and beam search at ``cfg.beam_size``, the caption metrics;
    with ``save_json`` res.json / gts.json go to the run dir. ``run_dir``
    defaults to the training loop's ``{save_dir}/{dataset}_cc_lr_{lr}``.
    ``backbone_cfg`` overrides X3D-L (e.g. ``quantized_eval``: the int8
    encoder, dynamic, as the JAX eval takes it)."""
    resolve_device(cfg.device)
    cfg = _global_batch(cfg, "eval_batch_size")
    word_map = load_word_map(cfg)
    run_dir = run_dir or os.path.join(cfg.save_dir, f"{cfg.dataset}_cc_lr_{cfg.lr}")
    data = _EveryFifth(CaptionDataset(cfg.file_root, cfg.dataset, split or cfg.eval_split))
    loader = make_data_loader(
        cfg.loader, data, cfg.eval_batch_size, shuffle=False, num_workers=cfg.num_workers,
        collate=caption_collate, pad_final=True,
    )
    model = build_caption_model(cfg, len(word_map), in_size=data.__getitem__(0)["pre"].shape[0],
                                backbone_cfg=backbone_cfg)
    model.load_state_dict(restore_run_state(run_dir, which))
    return evaluate_captions(model, loader, word_map, cfg.beam_size,
                             save_dir=run_dir if save_json else None)


def _step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed for optimizer step ``step``."""
    return ((seed + 1) << 32) | step


def run_caption_training(cfg: CaptionRunConfig) -> Dict[str, Any]:
    """Train and evaluate CC; returns {'last', 'test_best', 'steps',
    'resumed_from_step'} (scores dicts), or {'preempted_at_step'} after a
    SIGTERM."""
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of {sorted(_DTYPES)}")
    cfg = _global_batch(cfg, "batch_size", "eval_batch_size")
    word_map = load_word_map(cfg)
    save_path = os.path.join(cfg.save_dir, f"{cfg.dataset}_cc_lr_{cfg.lr}")
    with setup_logger(save_path, dataclasses.asdict(cfg)) as logger:
        return _run_caption(cfg, logger, save_path, word_map)


def _make_optimizer(cfg: CaptionRunConfig, model: Change3D, steps_per_epoch: int):
    """(optimizer, schedule): one Adam over the trainable parameters, with
    an ``encoder`` and a ``decoder`` group when their learning rates
    differ; the encoder left out when it is frozen."""
    schedule = shrink_schedule(cfg.lr, steps_per_epoch, shrink_every_epochs=10, factor=0.5)
    params = model.parameters()
    if not cfg.fine_tune_encoder:
        params = freeze_subtree(model, "encoder")
    elif cfg.encoder_lr is not None and cfg.encoder_lr != cfg.lr:
        enc = shrink_schedule(cfg.encoder_lr, steps_per_epoch, shrink_every_epochs=10, factor=0.5)
        dec = schedule
        params = per_subtree_lr(model, "encoder")
        schedule = lambda step: {"encoder": enc(step), "decoder": dec(step)}
    opt = torch_adam(params, weight_decay=cfg.weight_decay, grad_clip_value=cfg.grad_clip)
    return opt, schedule


def _run_caption(cfg: CaptionRunConfig, logger, save_path: str,
                 word_map: Dict[str, int]) -> Dict[str, Any]:
    device = resolve_device(cfg.device)
    compute_dtype = _DTYPES[cfg.compute_dtype]
    train_data = CaptionDataset(cfg.file_root, cfg.dataset, "TRAIN")
    eval_data = _EveryFifth(CaptionDataset(cfg.file_root, cfg.dataset, cfg.eval_split))
    train_loader = make_data_loader(
        cfg.loader, train_data, cfg.batch_size, shuffle=True, seed=cfg.seed,
        num_workers=cfg.num_workers, collate=caption_collate, drop_last=True,
    )
    eval_loader = make_data_loader(
        cfg.loader, eval_data, cfg.eval_batch_size, shuffle=False,
        num_workers=cfg.num_workers, collate=caption_collate, pad_final=True,
    )
    in_size = train_data.__getitem__(0, np.random.default_rng(0))["pre"].shape[0]
    model = build_caption_model(cfg, len(word_map), in_size=in_size)
    if cfg.pretrained:
        load_pretrained_backbone(model, cfg.pretrained)
    steps_per_epoch = max(len(train_loader), 1)
    opt, schedule = _make_optimizer(cfg, model, steps_per_epoch)
    decode_fn = make_decode_fn(model, cfg.beam_size, word_map)
    generator = torch.Generator(device=device)

    ckpt = CheckpointManager(save_path)
    best_bleu4 = -1.0
    start_epoch = resume_step = skip_batches = 0
    if cfg.resume:
        resume_step = ckpt.restore(model, opt)
        start_epoch, skip_batches = divmod(resume_step, steps_per_epoch)
        best_bleu4 = float(ckpt.load_meta().get("best_val", -1.0))
        print(f"[resume] restored step {resume_step}", flush=True)
    results: Dict[str, Any] = {"resumed_from_step": resume_step}

    def evaluate() -> Dict[str, float]:
        return evaluate_captions(model, eval_loader, word_map, cfg.beam_size,
                                 save_dir=save_path, decode_fn=decode_fn)

    def validate(epoch: int) -> None:
        nonlocal best_bleu4
        scores = evaluate()
        logger.log_epoch(epoch, scores)
        print(f"[epoch {epoch}] eval {scores}", flush=True)
        if scores["Bleu_4"] >= best_bleu4:
            best_bleu4 = scores["Bleu_4"]
            ckpt.save_best(model)
        ckpt.save_meta({"best_val": best_bleu4})
        results["last"] = scores

    # A preemption on an epoch's last step: that epoch trained fully but was
    # never evaluated (CC evaluates every epoch, 0 included).
    if (cfg.resume and resume_step > 0 and skip_batches == 0 and start_epoch >= 1
            and int(ckpt.load_meta().get("preempted_at_step", -1)) == resume_step):
        print(f"[resume] epoch {start_epoch - 1} completed right at the preemption point "
              f"but was never evaluated — evaluating now", flush=True)
        validate(start_epoch - 1)

    host_step = resume_step
    tracer = WindowTracer(cfg.profile_dir, device=device)
    with PreemptionGuard() as guard, contextlib.closing(tracer):
        for epoch in range(start_epoch, cfg.epochs):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            n_batches = len(train_loader)
            if epoch == start_epoch and skip_batches:
                print(f"[resume] epoch {epoch}: skipping {skip_batches} already-trained "
                      f"batches (mid-epoch checkpoint)", flush=True)
            batches = train_loader.iter_from(skip_batches if epoch == start_epoch else 0)
            loss_sum = top1_sum = None
            n_steps = 0
            for i, batch in enumerate(device_prefetch(batches, device)):
                tracer.tick(i)
                batch.pop("all_captions", None)
                generator.manual_seed(_step_seed(cfg.seed, host_step))
                metrics = train_step(model, opt, schedule, batch, host_step,
                                     compute_dtype=compute_dtype, generator=generator)
                if loss_sum is None:
                    loss_sum, top1_sum = metrics["loss"], metrics["top1"]
                else:
                    loss_sum, top1_sum = loss_sum + metrics["loss"], top1_sum + metrics["top1"]
                n_steps += 1
                host_step += 1
                guard.tick(host_step)
                if guard.agreed():
                    break
                if i % 50 == 0 and i:
                    eta = (time.time() - t0) / (i + 1) * (n_batches - i - 1)
                    print(f"  [epoch {epoch}] iter {i}/{n_batches} loss "
                          f"{float(metrics['loss']):.4f} top1 {float(metrics['top1']):.2f} "
                          f"eta {eta:.0f}s", flush=True)
            tracer.close()
            if guard.triggered:
                ckpt.save(host_step, model, opt)
                ckpt.save_meta({"best_val": best_bleu4, "preempted_at_step": host_step})
                print(f"[preempt] checkpoint saved at step {host_step}; exiting cleanly",
                      flush=True)
                results["preempted_at_step"] = host_step
                return results
            mean_loss = float(loss_sum) / n_steps if n_steps else float("nan")
            mean_top1 = float(top1_sum) / n_steps if n_steps else float("nan")
            print(f"[epoch {epoch}] loss {mean_loss:.4f} top1 {mean_top1:.2f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
            validate(epoch)
            ckpt.save(host_step, model, opt)

    results["steps"] = host_step
    try:
        ckpt.restore_best(model)
    except FileNotFoundError as e:  # no epoch has been evaluated
        print(f"best-model evaluation skipped (no best checkpoint): {e}")
        return results
    results["test_best"] = evaluate()
    logger.log_epoch(-1, results["test_best"], split="test_best")
    return results
