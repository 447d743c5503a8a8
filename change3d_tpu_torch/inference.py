"""Serving forward (counterpart of ``change3d_tpu/inference.py``).

``Predictor`` wraps a Change3D module on one device: numpy images in, numpy
masks out. Eval-mode BN runs from running statistics, so results do not
depend on the batch. ``predict_u8`` keeps the whole pipeline on the device:
uint8 pixels up, hardened (and bitpacked) masks down. The heads by task
(``models/trainer.py``): BCD 'change'; SCD 'pre', 'post' (classes) and
'change'; BDA 'cls' (classes) and 'loc'.

``predict_u8_async`` / ``finalize_u8`` split ``predict_u8`` in two: the
first launches the forward and the copies of its masks into pinned host
memory and returns at once, the second waits and unpacks, so a caller (the
serving batcher) overlaps one batch's fetch with the next batch's forward.
``TiledPredictor`` runs scenes of any size through a Predictor in fixed-size
batches of model-sized tiles.

``CaptionPredictor`` wraps a CC model: the encoder (fused blocks on the
card), then the KV-cached beam search; sentences out. ``from_checkpoint``
builds either from a run's ``best/model.pt``.

With ``shard=True`` (every local card) or an explicit ``devices`` list, a
Predictor or CaptionPredictor holds one replica of the model per device and
splits each batch into equal slices, one per device: each slice is launched
on its device's current stream before any result is fetched, and the
results come back in order (counterpart of the JAX ``shard=True``). The
batch must divide by ``batch_divisor``, the number of devices; eval BN is
per sample, so the results are the single-device predictor's.

A model built with ``quantized_eval`` runs its pointwise convs as int8
products on the predictor's device (``ops/quant.py``; the fused kernels
then stay off, as in JAX). ``quant_mode='static'`` needs calibrated ranges
first: ``calibrate_quant_scales`` records them with an fp32 unfused forward
(counterpart of the JAX function), ``quant_scales`` / ``set_quant_scales``
read and load them, and a Predictor refuses a static model without them.

Spans (``utils/profiling.py``) mark the stages of ``predict_u8``
(``c3d.predict``: ``.h2d``, ``.forward`` with its ``.encode`` and ``.heads``
(the heads and the hardening), ``.d2h``, ``.wait``, ``.unpack``)
and of a caption call (``c3d.caption``: ``.h2d``, ``.encode``, the search's
``.decode``, ``.detokenize``) in any trace.

``ClipClassifier`` wraps an X3D Kinetics classifier (``X3D(cfg,
head=True)``): uint8 clips up through a pinned staging buffer, normalised
on the device with Kinetics' mean and std, fp32 logits down. Its spans:
``c3d.classify`` (``.h2d``, ``.forward`` with its ``.encode``, the stem and
stages, and ``.head``, ``.d2h``).

``ArtifactPredictor`` and ``CaptionArtifactPredictor`` serve an exported
artifact (``export.py``) with the same ``predict`` / ``predict_probs`` /
``caption`` surface, on normalised float inputs; ``fixed_batch`` is the
batch an artifact was pinned to (None for a symbolic batch).
"""

from __future__ import annotations

import contextlib
import copy
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from change3d_tpu_torch.checkpoint.io import restore_best_state
from change3d_tpu_torch.data.datasets import CaptionDataset
from change3d_tpu_torch.device import resolve_device
from change3d_tpu_torch.export import load_exported, load_exported_captioner
from change3d_tpu_torch.models.caption_decoder import (
    DecodeGraphs,
    MAX_CAPTION_LEN,
    beam_search_decode,
    incremental_fns,
)
from change3d_tpu_torch.models.trainer import Change3D
from change3d_tpu_torch.models.x3d import X3D, X3DBottleneck, prepare_int8
from change3d_tpu_torch.parallel.mesh import local_device_count
from change3d_tpu_torch.utils.profiling import span

_CLASS_KEYS = ("pre", "post", "cls")
_BINARY_KEYS = ("change", "loc")


def postprocess_probs(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Raw head outputs -> soft maps as float32 numpy: binary heads pass
    through (sigmoid is in-model), class heads softmax to probabilities."""
    result = {}
    for key, val in out.items():
        val = val.float().cpu().numpy()
        if key in _CLASS_KEYS:
            e = np.exp(val - val.max(-1, keepdims=True))
            val = e / e.sum(-1, keepdims=True)
        result[key] = val
    return result


def _calibrated_sites(model: torch.nn.Module) -> List[Tuple[str, X3DBottleneck]]:
    """(name, bottleneck) of every site with static ranges."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, X3DBottleneck) and m.quant_mode in ("calibrate", "static")]


def quant_scales(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's int8 ranges: {'<bottleneck>.amax_a' / '.amax_c': fp32
    scalar} (NaN before calibration), the keys ``from_jax_variables`` gives
    a JAX 'quant' collection."""
    return {f"{n}.amax_{site}": getattr(m, f"amax_{site}").detach().clone()
            for n, m in _calibrated_sites(model) for site in ("a", "c")}


@torch.no_grad()
def set_quant_scales(model: torch.nn.Module, scales: Dict[str, torch.Tensor]) -> None:
    """Load ranges (``quant_scales``' keys; every site of the model) into a
    static model."""
    missing = sorted(set(quant_scales(model)) - set(scales))
    if missing:
        raise KeyError(f"no range for {len(missing)} sites, e.g. {missing[0]}")
    for n, m in _calibrated_sites(model):
        for site in ("a", "c"):
            getattr(m, f"amax_{site}").copy_(torch.as_tensor(scales[f"{n}.amax_{site}"]))


@torch.no_grad()
def calibrate_quant_scales(model: torch.nn.Module, batches) -> Dict[str, torch.Tensor]:
    """Record the static int8 ranges of a model built with
    ``quantized_eval`` and ``quant_mode`` 'static' (or 'calibrate'): an fp32
    eval forward with fusion off over every (pre, post) pair of ``batches``
    (numpy or tensors) on the model's device, each site keeping its running
    max-abs from 0, as JAX's calibration pass does. The ranges stay in the
    model and are returned (``quant_scales``)."""
    sites = [m for _, m in _calibrated_sites(model)]
    if not sites:
        raise ValueError("calibrate_quant_scales needs a model built with quantized_eval and "
                         "quant_mode 'static' or 'calibrate'")
    device = next(model.parameters()).device
    was_training, modes = model.training, [m.quant_mode for m in sites]
    model.eval()
    for m in sites:
        m.quant_mode = "calibrate"
        m.amax_a.zero_()
        m.amax_c.zero_()
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a
                                    ).to(device=device, dtype=torch.float32)
    seen = 0
    try:
        for pre, post in batches:
            model(put(pre), put(post))
            seen += 1
    finally:
        for m, mode in zip(sites, modes):
            m.quant_mode = mode
        model.train(was_training)
    if not seen:
        raise ValueError("calibration saw no batches")
    return quant_scales(model)


class U8Launch(NamedTuple):
    """A launched ``predict_u8`` forward: the hardened masks (bitpacked
    binary masks, uint8 class maps) in pinned host tensors that the copies
    still fill, the event recorded after those copies (None on the CPU,
    where everything is done), the input width for the unpacking, and a
    sharded predictor's events on its other cards."""

    out: Dict[str, torch.Tensor]
    event: Optional[torch.cuda.Event]
    width: int
    more_events: Tuple[torch.cuda.Event, ...] = ()


def _on(device: torch.device):
    """``device`` made current for CUDA launches (nothing for the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _concat(parts: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    if len(parts) == 1:
        return parts[0]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


class Predictor:
    def __init__(self, model: Change3D, *, compute_dtype: torch.dtype = torch.bfloat16,
                 device="cuda", shard: bool = False, devices: Optional[Sequence] = None):
        """Runs ``model`` in eval mode on ``device`` (CUDA by default; raises
        without a card unless ``device="cpu"``) with activations in
        ``compute_dtype``. ``devices`` (or ``shard=True``: every local card,
        or the CPU once for ``device="cpu"``) spreads each batch over one
        replica per device; ``model`` is the first. An int8 model's weights
        are quantised here; a static one needs its ranges
        (``calibrate_quant_scales``)."""
        if devices is None:
            dev = resolve_device(device)
            devices = ([torch.device("cuda", i) for i in range(local_device_count())]
                       if shard and dev.type == "cuda" else [dev])
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a Predictor needs at least one device")
        # A card named without its index is the current one, fixed now.
        self.devices = [torch.device("cuda", torch.cuda.current_device())
                        if d.type == "cuda" and d.index is None else d for d in self.devices]
        self.device = self.devices[0]
        self.model = model.to(self.device).eval()
        prepare_int8(self.model)
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d)
                                        for d in self.devices[1:]]
        # Every batch splits into equal slices over the devices; the server
        # keeps only the buckets this divides.
        self.batch_divisor = len(self.devices)
        self.compute_dtype = compute_dtype
        pows = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32)
        self._pows = {d: pows.to(d) for d in self.devices}

    @classmethod
    def from_checkpoint(cls, model: Change3D, run_dir: str, **kw) -> "Predictor":
        """A Predictor over ``{run_dir}/best/model.pt`` loaded into ``model``;
        ``kw`` goes to the constructor."""
        model.load_state_dict(restore_best_state(run_dir))
        return cls(model, **kw)

    def _put(self, arr, device: Optional[torch.device] = None) -> torch.Tensor:
        """A numpy array (or a tensor) on ``device`` (default: the first)."""
        if isinstance(arr, np.ndarray):
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        return arr.to(device or self.device)

    def _run_shards(self, fn, *arrays) -> list:
        """``fn(device, replica, *slices)`` for every device's equal slice of
        the arrays, in turn, with that device current; the results in
        device order."""
        n, b = len(self.devices), arrays[0].shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split over the predictor's {n} devices")
        k = b // n
        outs = []
        for i, (dev, model) in enumerate(zip(self.devices, self.replicas)):
            with _on(dev):
                outs.append(fn(dev, model, *(a[i * k:(i + 1) * k] for a in arrays)))
        return outs

    @torch.inference_mode()
    def _forward(self, pre: torch.Tensor, post: torch.Tensor, model=None
                 ) -> Dict[str, torch.Tensor]:
        model = model or self.model
        return model(pre.to(self.compute_dtype), post.to(self.compute_dtype))

    def predict_probs(self, pre: np.ndarray, post: np.ndarray) -> Dict[str, np.ndarray]:
        """Soft maps: binary heads ('change', 'loc') as sigmoid
        probabilities [B,H,W,1], class heads ('pre', 'post', 'cls') as
        softmax probabilities [B,H,W,C]."""
        outs = self._run_shards(lambda dev, model, a, b: self._forward(
            self._put(a, dev), self._put(b, dev), model), pre, post)
        return _concat([postprocess_probs(o) for o in outs])

    @staticmethod
    def harden(probs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Soft maps -> decisions: binary heads thresholded at 0.5, class
        heads argmaxed."""
        result = {}
        for key, val in probs.items():
            if key in _BINARY_KEYS:
                result[key] = val[..., 0] > 0.5
            elif key in _CLASS_KEYS:
                result[key] = val.argmax(-1)
            else:
                result[key] = val
        return result

    def predict(self, pre: np.ndarray, post: np.ndarray) -> Dict[str, np.ndarray]:
        """pre/post: [B,H,W,3] normalized float images. Returns per-task
        masks: BCD {'change': bool}; SCD {'pre', 'post': class ids,
        'change': bool}; BDA {'cls': class ids, 'loc': bool}."""
        return self.harden(self.predict_probs(pre, post))

    @torch.inference_mode()
    def predict_u8_device(self, pre: torch.Tensor, post: torch.Tensor) -> Dict[str, torch.Tensor]:
        """uint8 [B,H,W,3] device tensors -> hardened masks on the device.
        Class maps come back as uint8 argmax ids; binary masks bitpacked
        (uint8, 8 pixels per byte, np.unpackbits order) when the width is a
        multiple of 8. A sharded predictor copies each slice to its card and
        gathers the masks on the first."""
        outs = self._u8_shards(pre, post)
        if len(outs) == 1:
            return outs[0]
        return {k: torch.cat([o[k].to(self.device) for o in outs]) for k in outs[0]}

    def _u8_shards(self, pre, post) -> List[Dict[str, torch.Tensor]]:
        """Every device's hardened masks of its slice, on that device."""

        def run(dev, model, a, b):
            with span("c3d.predict.h2d"):
                a, b = self._put(a, dev), self._put(b, dev)
            return self._u8_on(model, a, b)

        return self._run_shards(run, pre, post)

    def _u8_on(self, model, pre: torch.Tensor, post: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``predict_u8_device`` on one replica and its device's tensors."""

        def norm(a):
            # fp32 first with eval_normalize's op sequence, then the cast: the
            # model sees the same inputs as on the host-normalized float path.
            return ((a.float() / 255.0 - 0.5) / 0.5).to(self.compute_dtype)

        with span("c3d.predict.forward"):
            # The model's forward, called in its two halves so that each has
            # a span: no span may sit inside a forward (utils/profiling.py).
            with span("c3d.predict.encode"):
                taps = model.encoder(norm(pre), norm(post))
            with span("c3d.predict.heads"):
                hard = {}
                for key, val in model.heads(taps).items():
                    if key in _BINARY_KEYS:
                        mask = val[..., 0] > 0.5
                        b, h, w = mask.shape
                        if w % 8 == 0:
                            grouped = mask.reshape(b, h, w // 8, 8).to(torch.int32)
                            mask = (grouped * self._pows[mask.device]).sum(-1).to(torch.uint8)
                        hard[key] = mask
                    else:
                        hard[key] = torch.argmax(val, dim=-1).to(torch.uint8)
        return hard

    @torch.inference_mode()
    def predict_u8_async(self, pre: np.ndarray, post: np.ndarray) -> U8Launch:
        """Launch the uint8 forward on the current stream and the copies of
        its hardened masks into freshly pinned host tensors, record an event
        after them and return without waiting; :meth:`finalize_u8` waits.
        Each call has its own host buffers, so launches may overlap. On the
        CPU the work is done on return. A sharded predictor launches every
        card's slice, and each card copies its masks into its rows."""
        if self.device.type != "cuda":
            return U8Launch(self.predict_u8_device(pre, post), None, pre.shape[2])
        outs = self._u8_shards(pre, post)
        with span("c3d.predict.d2h"):
            host = {key: torch.empty((len(pre),) + val.shape[1:], dtype=val.dtype,
                                     pin_memory=True)
                    for key, val in outs[0].items()}
            k, events = len(pre) // len(outs), []
            for i, (dev, out) in enumerate(zip(self.devices, outs)):
                with _on(dev):
                    for key, val in out.items():
                        host[key][i * k:(i + 1) * k].copy_(val, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                    events.append(event)
        return U8Launch(host, events[0], pre.shape[2], tuple(events[1:]))

    @staticmethod
    def finalize_u8(launch: U8Launch) -> Dict[str, np.ndarray]:
        """Wait for a :meth:`predict_u8_async` launch and unpack its masks:
        bool binary masks [B, H, W] and uint8 class ids."""
        with span("c3d.predict.wait"):
            for event in (launch.event,) + launch.more_events:
                if event is not None:
                    event.synchronize()
        fetched = {}
        with span("c3d.predict.unpack"):
            for key, val in launch.out.items():
                arr = val.numpy()
                if key in _BINARY_KEYS and launch.width % 8 == 0:
                    arr = np.unpackbits(arr, axis=-1).astype(bool)[..., :launch.width]
                fetched[key] = arr
        return fetched

    def predict_u8(self, pre: np.ndarray, post: np.ndarray) -> Dict[str, np.ndarray]:
        """Raw [B,H,W,3] uint8 in, hardened masks out (the same decisions as
        :meth:`predict` on eval-normalized floats): bool binary masks and
        uint8 class ids, keyed as in :meth:`predict`."""
        with span("c3d.predict"):
            return self.finalize_u8(self.predict_u8_async(pre, post))


class ClipClassifier:
    """Kinetics logits for uint8 video clips from an X3D classifier
    (``X3D(cfg, head=True)``, e.g. ``x3d_classifier("l")``) in eval mode on
    ``device`` (CUDA by default; raises without a card unless
    ``device="cpu"``), activations in ``compute_dtype``. Eval BN runs from
    running statistics, so each clip's logits do not depend on the others
    in its batch; the folded BNs and the fused blocks' weights are kept
    between calls (``InferenceCache``), as in ``Predictor``."""

    # pytorchvideo's Kinetics transform: x / 255, then this mean and std on
    # every channel.
    MEAN, STD = 0.45, 0.225

    def __init__(self, model: X3D, *, compute_dtype: torch.dtype = torch.bfloat16,
                 device="cuda"):
        if model.head is None:
            raise ValueError("a ClipClassifier needs the Kinetics head: build X3D(cfg, head=True)")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device, self.compute_dtype = dev, compute_dtype
        self.model = model.to(dev).eval()
        # The pinned host buffer clips are staged through, and the event
        # after the last copy out of it (the next call writes it again).
        # 30 clips of 16 x 312^2 reach an H100 in 10.6 ms this way against
        # 22.6 ms by a pageable .to(device): 196.5 against 182.2 clips/s.
        self._staging: Optional[torch.Tensor] = None
        self._staged: Optional[torch.cuda.Event] = None

    def _put(self, clips: np.ndarray) -> torch.Tensor:
        """uint8 clips on the device: on a card through the pinned buffer
        (re-made for another shape), copied up asynchronously."""
        host = torch.from_numpy(np.require(clips, requirements=("C", "W")))
        if self.device.type != "cuda":
            return host
        if self._staging is None or self._staging.shape != host.shape:
            self._staging = torch.empty(host.shape, dtype=torch.uint8, pin_memory=True)
        elif self._staged is not None:
            self._staged.synchronize()
        self._staging.copy_(host)
        out = self._staging.to(self.device, non_blocking=True)
        self._staged = torch.cuda.Event()
        self._staged.record()
        return out

    def normalize(self, clips: torch.Tensor) -> torch.Tensor:
        """uint8 [B, T, H, W, 3] device clips -> the model's input in
        ``compute_dtype``: (x / 255 - MEAN) / STD in fp32, then the cast."""
        return ((clips.float() / 255.0 - self.MEAN) / self.STD).to(self.compute_dtype)

    @torch.inference_mode()
    def logits_device(self, clips: torch.Tensor) -> torch.Tensor:
        """uint8 device clips -> fp32 logits [B, num_classes] on the device:
        ``model(clip, classify=True)`` in its two halves, each with a span."""
        with span("c3d.classify.forward"):
            with span("c3d.classify.encode"):
                x = self.model.features(self.normalize(clips))
            with span("c3d.classify.head"):
                return self.model.head(x).float()

    def classify_u8(self, clips: np.ndarray) -> np.ndarray:
        """uint8 [B, T, H, W, 3] clips on the host -> fp32 logits [B,
        num_classes] (before the softmax) on the host."""
        clips = np.asarray(clips)
        if clips.dtype != np.uint8 or clips.ndim != 5 or clips.shape[-1] != 3:
            raise ValueError(f"classify_u8 takes uint8 [B, T, H, W, 3] clips, got "
                             f"{clips.dtype} {clips.shape}")
        with span("c3d.classify"):
            with span("c3d.classify.h2d"):
                x = self._put(clips)
            logits = self.logits_device(x)
            with span("c3d.classify.d2h"):  # waits for the forward
                return logits.cpu().numpy()


def _artifact_geometry(fn):
    """(a model stand-in with the artifact's in_height / in_width, its
    pinned batch or None when the batch is symbolic)."""
    b, h, w, _ = fn.input_shape
    return SimpleNamespace(in_height=int(h), in_width=int(w)), (b if isinstance(b, int) else None)


class ArtifactPredictor:
    """``Predictor``'s float surface (``predict_probs``, ``predict``) over an
    exported detection artifact (counterpart of the JAX
    ``ArtifactPredictor``), so ``TiledPredictor`` and the server take either.
    The input geometry is the artifact's; ``fixed_batch`` is its pinned
    batch, or None when the batch is symbolic. Runs on ``device`` (CUDA by
    default; raises without a card unless ``device="cpu"``)."""

    def __init__(self, path_or_bytes, device="cuda"):
        self._fn = load_exported(path_or_bytes, device)
        self.model, self.fixed_batch = _artifact_geometry(self._fn)

    def predict_probs(self, pre: np.ndarray, post: np.ndarray) -> Dict[str, np.ndarray]:
        return postprocess_probs(self._fn(pre, post))

    def predict(self, pre: np.ndarray, post: np.ndarray) -> Dict[str, np.ndarray]:
        return Predictor.harden(self.predict_probs(pre, post))


class TiledPredictor:
    """Full-scene inference (counterpart of the JAX ``TiledPredictor``):
    the model's (in_height, in_width) window slides over the scene with
    ``overlap``, the tiles go through :meth:`Predictor.predict_probs` in
    batches of exactly ``batch_size`` (the last padded by repeating its
    last tile), the soft maps are cosine-blended over the overlaps and
    hardened once, so seams average in probability space."""

    def __init__(self, predictor: Predictor, *, overlap: int = 32, batch_size: int = 16):
        if overlap < 0 or overlap >= min(predictor.model.in_height, predictor.model.in_width):
            raise ValueError(f"overlap {overlap} must be in [0, tile size)")
        self.predictor = predictor
        self.overlap = overlap
        self.batch_size = batch_size

    def predict_scene_probs(self, pre: np.ndarray, post: np.ndarray) -> Dict[str, np.ndarray]:
        """pre/post: one [H, W, 3] normalized float scene, any size. Returns
        the blended soft maps at scene resolution. Tiles are cut and blended
        batch by batch, so host memory stays O(scene)."""
        from change3d_tpu_torch.utils.tiling import blend_window, pad_scene, scene_offsets

        th, tw = self.predictor.model.in_height, self.predictor.model.in_width
        pre_p = pad_scene(np.asarray(pre, np.float32), th, tw)
        post_p = pad_scene(np.asarray(post, np.float32), th, tw)
        ch, cw = pre_p.shape[:2]
        offsets = scene_offsets(ch, cw, th, tw, self.overlap)
        win = blend_window(th, tw, self.overlap)[..., None]
        acc: Dict[str, np.ndarray] = {}
        wacc = np.zeros((ch, cw, 1), np.float32)
        b = self.batch_size
        for i in range(0, len(offsets), b):
            group = offsets[i:i + b]
            pad = [group[-1]] * (b - len(group))
            pre_t = np.stack([pre_p[y:y + th, x:x + tw] for y, x in group + pad])
            post_t = np.stack([post_p[y:y + th, x:x + tw] for y, x in group + pad])
            probs = self.predictor.predict_probs(pre_t, post_t)
            for j, (y, x) in enumerate(group):
                for key, val in probs.items():
                    if key not in acc:
                        acc[key] = np.zeros((ch, cw, val.shape[-1]), np.float32)
                    acc[key][y:y + th, x:x + tw] += val[j] * win
                wacc[y:y + th, x:x + tw] += win
        h0, w0 = pre.shape[:2]
        return {key: (a / wacc)[:h0, :w0] for key, a in acc.items()}

    def predict_scene(self, pre: np.ndarray, post: np.ndarray) -> Dict[str, np.ndarray]:
        """Hardened scene-resolution maps ([H, W] bool / class ids), the
        decision rules of :meth:`Predictor.predict`."""
        return Predictor.harden(self.predict_scene_probs(pre, post))


def tokens_to_captions(tokens, word_map: Dict[str, int]) -> List[str]:
    """Decoded id rows -> sentences, without <start>/<end>/<pad>."""
    rev = {v: k for k, v in word_map.items()}
    special = {word_map["<start>"], word_map["<end>"], word_map.get("<pad>", 0)}
    return [" ".join(rev.get(int(t), "<unk>") for t in row if int(t) not in special)
            for row in np.asarray(tokens)]


class CaptionPredictor(Predictor):
    """Captions for image pairs from a CC ``Change3D``: the encoder in
    ``compute_dtype``, then ``beam_search_decode`` with ``beam_size`` beams
    over the KV-cached decode step, at most MAX_CAPTION_LEN tokens; on a
    card each step replays a CUDA graph of the replica's ``DecodeGraphs``
    (captured at a batch's first search).
    ``shard`` / ``devices`` as for ``Predictor`` (``caption`` and
    ``caption_u8`` split the batch; ``caption_device`` runs the first)."""

    def __init__(self, model: Change3D, word_map: Dict[str, int], *, beam_size: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16, device="cuda", shard: bool = False,
                 devices: Optional[Sequence] = None):
        super().__init__(model, compute_dtype=compute_dtype, device=device, shard=shard,
                         devices=devices)
        self.word_map = word_map
        self.beam_size = beam_size
        mean, std = torch.from_numpy(CaptionDataset.MEAN), torch.from_numpy(CaptionDataset.STD)
        self._mean_std = {d: (mean.to(d), std.to(d)) for d in self.devices}
        self.decode_graphs = {id(m): DecodeGraphs(m.decoder) for m in self.replicas}

    @torch.inference_mode()
    def encode(self, pre: torch.Tensor, post: torch.Tensor, model=None) -> torch.Tensor:
        """Device tensors [B, H, W, 3] -> the image memory [B, h*w, C] in
        ``compute_dtype``. uint8 pixels are normalised here with ImageNet's
        mean and std (``CaptionDataset``'s), in fp32 before the cast; float
        images are taken as normalised. ``model``: a replica (default: the
        first) on the tensors' device."""
        if pre.dtype == torch.uint8:
            mean, std = self._mean_std[pre.device]
            norm = lambda a: (a.float() / 255.0 - mean) / std
            pre, post = norm(pre), norm(post)
        model = model or self.model
        return model(pre.to(self.compute_dtype), post.to(self.compute_dtype))["memory"]

    @torch.inference_mode()
    def decode(self, memory: torch.Tensor, model=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """KV-cached beam search over ``memory``: (tokens [B,
        MAX_CAPTION_LEN], scores [B]) on the device."""
        wm, model = self.word_map, model or self.model
        return beam_search_decode(
            None, memory, beam_size=self.beam_size,
            start_token=wm["<start>"], end_token=wm["<end>"], pad_token=wm.get("<pad>", 0),
            max_len=MAX_CAPTION_LEN, incremental=incremental_fns(model),
            graphs=self.decode_graphs.get(id(model)))

    def caption_device(self, pre: torch.Tensor, post: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device tensors in (uint8 or normalised floats), (tokens, scores)
        on the device out."""
        return self.decode(self.encode(pre, post))

    def _caption_shards(self, pre: np.ndarray, post: np.ndarray) -> List[str]:
        def run(dev, model, a, b):
            with span("c3d.caption.h2d"):
                a, b = self._put(a, dev), self._put(b, dev)
            with span("c3d.caption.encode"):
                memory = self.encode(a, b, model)
            return self.decode(memory, model)[0]

        with span("c3d.caption"):
            tokens = self._run_shards(run, pre, post)
            with span("c3d.caption.detokenize"):
                return tokens_to_captions(torch.cat([t.cpu() for t in tokens]).numpy(),
                                          self.word_map)

    def caption(self, pre: np.ndarray, post: np.ndarray) -> List[str]:
        """Normalised float [B, H, W, 3] pairs -> one sentence per pair."""
        return self._caption_shards(pre.astype(np.float32), post.astype(np.float32))

    def caption_u8(self, pre: np.ndarray, post: np.ndarray) -> List[str]:
        """Raw uint8 [B, H, W, 3] pairs; only uint8 pixels go to the device."""
        return self._caption_shards(pre, post)


class CaptionArtifactPredictor:
    """``caption()`` over an exported caption artifact (counterpart of the
    JAX ``CaptionArtifactPredictor``): the encoder and the beam search are
    baked in, the word map comes separately (ids are the vocabulary).
    Inputs are ImageNet-normalised floats [B, H, W, 3]."""

    def __init__(self, path_or_bytes, word_map: Dict[str, int], device="cuda"):
        self._fn = load_exported_captioner(path_or_bytes, device)
        self.word_map = word_map
        self.model, self.fixed_batch = _artifact_geometry(self._fn)

    def caption(self, pre: np.ndarray, post: np.ndarray) -> List[str]:
        tokens, _ = self._fn(pre, post)
        return tokens_to_captions(tokens.cpu().numpy(), self.word_map)
