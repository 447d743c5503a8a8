"""Ahead-of-time export (counterpart of ``change3d_tpu/export.py``): a
trained Change3D forward as one self-contained ``torch.export`` artifact
(``.pt2``), served without the model's code.

- ``export_model``: ``fn(pre, post) -> {head: fp32 map}``. Float [B, H, W, 3]
  inputs (eval-normalised) are cast to ``compute_dtype`` and the outputs
  back to fp32, as JAX's exported forward does.
- ``export_caption_model``: the encoder plus the KV-cached beam search
  (``beam_search_loop``, one ``while_loop``) -> ``(tokens int32 [B, 52],
  scores fp32 [B])``, with the beam width and special tokens baked in.
  Inputs are ImageNet-normalised floats; the word map travels separately.

An int8 model (``quantized_eval``) exports its int8 weights, scales and
calibrated ranges as constants and its products as ``aten._int_mm`` nodes,
their padding static under a symbolic batch (``ops/quant.py``).

The batch is symbolic (one artifact for every batch size) unless ``batch``
pins it. Export runs in eval mode with gradients off, and the weights
travel inside the file. The fused blocks are the custom ops
``c3d::fused_block_fwd`` / ``c3d::fused_block_se_sums``, and the stem's and
strided blocks' depthwise convs ``c3d::depthwise_conv3d``, one graph node per
launch: an artifact exported on the CPU runs the CUDA kernels once moved to
the card, as JAX's ``platforms=("cpu", "tpu")`` artifact does. The loaders
move a program to ``device`` (``move_to_device_pass``) and need no model
class. A ``.pt2`` is loaded by the torch version that wrote it.

Usage::

    from change3d_tpu_torch.export import export_model, load_exported
    export_model(model, "bcd.pt2")
    fn = load_exported("bcd.pt2")          # (pre, post) -> {"change": ...}
"""

from __future__ import annotations

import io
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

# Registers the c3d:: custom ops that artifacts call.
import change3d_tpu_torch.ops.depthwise_conv  # noqa: F401
import change3d_tpu_torch.ops.fused_block  # noqa: F401
from change3d_tpu_torch.checkpoint.io import restore_best_state
from change3d_tpu_torch.device import resolve_device
from change3d_tpu_torch.models.caption_decoder import (
    MAX_CAPTION_LEN,
    beam_search_loop,
    incremental_fns,
)
from change3d_tpu_torch.models.x3d import prepare_int8


class _Forward(nn.Module):
    """The exported detection forward: inputs cast to ``compute_dtype``,
    outputs to fp32."""

    def __init__(self, model: nn.Module, compute_dtype: torch.dtype):
        super().__init__()
        self.model, self.compute_dtype = model, compute_dtype

    def forward(self, pre: torch.Tensor, post: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.model(pre.to(self.compute_dtype), post.to(self.compute_dtype))
        return {k: v.float() for k, v in out.items()}


class _CaptionForward(nn.Module):
    """The exported caption pipeline: encoder, then the beam search."""

    def __init__(self, model: nn.Module, word_map: Dict[str, int], beam_size: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.model, self.compute_dtype, self.beam_size = model, compute_dtype, beam_size
        self.special = (word_map["<start>"], word_map["<end>"], word_map.get("<pad>", 0))

    def forward(self, pre: torch.Tensor, post: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        memory = self.model(pre.to(self.compute_dtype), post.to(self.compute_dtype))["memory"]
        start, end, pad = self.special
        tokens, scores = beam_search_loop(
            memory, beam_size=self.beam_size, start_token=start, end_token=end, pad_token=pad,
            max_len=MAX_CAPTION_LEN, incremental=incremental_fns(self.model))
        return tokens.to(torch.int32), scores.float()


def _export(wrapper: nn.Module, model: nn.Module, batch: Optional[int],
            path: Optional[str]) -> bytes:
    """Trace ``wrapper`` on zero inputs of the model's geometry on its
    device (at batch 2 when the batch stays symbolic), save the program and
    return its bytes (written to ``path`` too, if given)."""
    dev = next(model.parameters()).device
    n = batch if batch is not None else 2
    # Two tensors: export would trace one tensor passed twice as one input.
    x = [torch.zeros((n, model.in_height, model.in_width, 3), dtype=torch.float32, device=dev)
         for _ in range(2)]
    dims = None
    if batch is None:
        b = torch.export.Dim("b", min=1)
        dims = ({0: b}, {0: b})
    was_training = model.training
    model.eval()
    prepare_int8(model)
    try:
        with torch.no_grad():
            program = torch.export.export(wrapper, tuple(x), dynamic_shapes=dims)
    finally:
        model.train(was_training)
    program.example_inputs = None  # the zero inputs would travel in the file
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def export_model(model: nn.Module, path: Optional[str] = None, *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 batch: Optional[int] = None) -> bytes:
    """Export a detection ``Change3D`` (BCD, SCD, BDA) on its device with
    its current weights; ``batch=None`` keeps the batch symbolic. Returns
    the artifact's bytes and writes them to ``path`` if given."""
    return _export(_Forward(model, compute_dtype), model, batch, path)


def export_from_checkpoint(model: nn.Module, save_path: str, out_path: str, **kw) -> bytes:
    """Load ``{save_path}/best/model.pt`` into ``model`` and export it."""
    model.load_state_dict(restore_best_state(save_path))
    return export_model(model, out_path, **kw)


def export_caption_model(model: nn.Module, word_map: Dict[str, int],
                         path: Optional[str] = None, *, beam_size: int = 1,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         batch: Optional[int] = None) -> bytes:
    """Export a CC ``Change3D``'s whole captioning pipeline (encoder and
    beam search at ``beam_size``): ``fn(pre, post) -> (tokens, scores)``."""
    return _export(_CaptionForward(model, word_map, beam_size, compute_dtype), model, batch,
                   path)


def _load(path_or_bytes, device) -> Callable:
    """The artifact's program on ``device`` as ``fn(pre, post)``: numpy or
    tensor inputs as fp32 on that device, run under inference mode.
    ``fn.input_shape`` is (batch, H, W, 3) from the input placeholders, a
    symbolic batch as its name (a str); ``fn.program`` the
    ``ExportedProgram``."""
    dev = resolve_device(device)
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, (bytes, bytearray)) \
        else path_or_bytes
    program = torch.export.load(src)
    program = move_to_device_pass(program, dev)
    module = program.module()
    user_inputs = set(program.graph_signature.user_inputs)
    first = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name in user_inputs)
    shape = tuple(d if isinstance(d, int) else str(d) for d in first.meta["val"].shape)

    def put(a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        return a.to(device=dev, dtype=torch.float32)

    @torch.inference_mode()
    def fn(pre, post):
        return module(put(pre), put(post))

    fn.input_shape = shape
    fn.program = program
    return fn


def load_exported(path_or_bytes, device="cuda") -> Callable:
    """Load a detection artifact onto ``device`` (CUDA by default; raises
    without a card unless ``device="cpu"``): ``fn(pre, post) -> {head: fp32
    tensor}``."""
    return _load(path_or_bytes, device)


def load_exported_captioner(path_or_bytes, device="cuda") -> Callable:
    """Load a caption artifact onto ``device``: ``fn(pre, post) -> (tokens,
    scores)``."""
    return _load(path_or_bytes, device)
