"""Weight bridges into this port's state_dict: from the JAX package's
variables, and from the reference's torch checkpoints (below).

``from_jax_variables`` takes the ``{'params', 'batch_stats'[, 'quant']}``
tree of a ``change3d_tpu`` Change3D (or bare X3D) as numpy arrays and
returns the state_dict of the matching port module; a 'quant' collection
(calibrated int8 ranges) gives the ``...bottleneck.amax_{a,c}`` buffers,
which ``inference.set_quant_scales`` loads. It un-stacks the scan layout
(``stageK/pairs/{a,b}`` carry a leading axis: a[p] is block 2p+1, b[p] block
2p+2; a trailing odd block stays ``block{depth-1}``) and transposes conv
kernels to the port's layouts:

  conv3d  DHWIO (kt,kh,kw,I,O)  -> (O, I, kt, kh, kw)
  conv2d  HWIO  (kh,kw,I,O)     -> (O, I, kh, kw)
  up      (kh,kw,I,O)           -> (I, O, kh, kw)  (ConvTranspose, not flipped)
  block-0 projection (1,1,1,I,O) -> [I, O]
  pointwise / SE / FC [I, O]    -> unchanged
  caption decoder (``decoder/...``: embedding, attention and output
  matrices [in, out], LayerNorm scale/bias) -> unchanged

Detection trees come without ``stage4`` (flax never materialises it there);
a CC tree has stage4 for CC and the caption decoder. The Kinetics head of a
bare X3D tree (``head/{pre_conv, pre_bn, post_conv, proj_w, proj_b}``, [in,
out] matrices as the port keeps them) is carried as ``head.*`` for a port
``X3D(cfg, head=True)`` (``head=True``), and dropped otherwise.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from change3d_tpu_torch.models.x3d import X3DConfig, x3d_l_config

def _walk(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _unstack_pairs(path, value):
    """Yield (path, value) with ``stageK/pairs/{a,b}/...`` split into
    ``stageK/block{j}/...``."""
    if "pairs" not in path:
        yield path, value
        return
    i = path.index("pairs")
    first = 1 if path[i + 1] == "a" else 2
    for p in range(value.shape[0]):
        yield path[:i] + (f"block{2 * p + first}",) + path[i + 2:], value[p]


def _convert_leaf(path, v: np.ndarray) -> np.ndarray:
    name = path[-1]
    if name in ("conv_s", "conv_t", "conv_b"):          # DHWIO
        return v.transpose(4, 3, 0, 1, 2)
    if name == "proj":                                   # strided 1x1x1
        return v[0, 0, 0]
    if name in ("reduce", "final"):                      # HWIO
        return v.transpose(3, 2, 0, 1)
    if name == "up":                                     # (kh,kw,I,O)
        return v.transpose(2, 3, 0, 1)
    return v


def from_jax_variables(variables: Mapping, cfg: Optional[X3DConfig] = None, *,
                       head: bool = False) -> Dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'[, 'quant']}`` (numpy leaves) -> port
    state_dict (with the ``amax_*`` ranges of a 'quant' collection). The
    Kinetics head's leaves come along with ``head`` (the target is an
    ``X3D(cfg, head=True)``) and are dropped without.

    Raises if a stage present in the tree does not hold exactly
    ``cfg.stage_depths`` blocks."""
    cfg = cfg or x3d_l_config()
    out: Dict[str, torch.Tensor] = {}
    blocks: Dict[str, set] = {}
    for collection in ("params", "batch_stats", "quant"):
        for path, value in _walk(variables.get(collection, {})):
            if "head" in path and not head:
                continue
            for p, v in _unstack_pairs(path, value):
                key = ".".join(p)
                if key in out:
                    raise ValueError(f"duplicate key {key}")
                out[key] = torch.from_numpy(np.array(_convert_leaf(p, v), order="C"))
                stage = next((s for s in p if s.startswith("stage")), None)
                if stage is not None:
                    blocks.setdefault(stage, set()).add(p[p.index(stage) + 1])
    for stage, found in blocks.items():
        want = {f"block{j}" for j in range(cfg.stage_depths[int(stage[5:]) - 1])}
        if found != want:
            raise ValueError(f"{stage}: blocks {sorted(found)} do not match depth {len(want)}")
    return out


# ---------------------------------------------------------------------------
# Reference checkpoints: Kinetics ``X3D_L.pyth`` and trained ``Trainer``s
# ---------------------------------------------------------------------------
#
# The reference's torch files name the X3D with pytorchvideo's keys. They map
# straight onto this port's names; only the 1x1x1 convs and the Kinetics
# projection change layout (to [in, out] matrices), and ``conv_t`` holds the
# spatial 1x3x3 stem conv (the reference swaps Conv2plus1d's arguments):
#
#   blocks.0.conv.conv_t / conv_xy / norm        -> stem.conv_s / conv_t / bn
#   blocks.S.res_blocks.J.branch1_conv / _norm   -> stageS.blockJ.proj / proj_bn
#   blocks.S.res_blocks.J.branch2.conv_a, norm_a -> stageS.blockJ.bottleneck.conv_a, bn_a
#     .conv_b, .norm_b.0, .norm_b.1.block.{0,2}  -> .conv_b, .bn_b, .se.{w,b}_{reduce,expand}
#     .conv_c, .norm_c                           -> .conv_c, .bn_c
#   blocks.5.pool.pre_conv / pre_norm / post_conv, blocks.5.proj
#                                                -> head.pre_conv / pre_bn / post_conv, proj_w/_b
#
# BN: weight/bias/running_mean/running_var -> scale/bias/mean/var;
# num_batches_tracked is dropped. ``head.*`` are the names of the port's
# ``X3DHead``: an ``X3D(cfg, head=True)`` loads the converted dict as it is;
# ``merge_backbone_variables`` drops the head for a Change3D model.

def _bn_keys(m: Dict[str, tuple], torch_prefix: str, port_prefix: str) -> None:
    for t, p in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                 ("running_var", "var")):
        m[f"{torch_prefix}.{t}"] = (f"{port_prefix}.{p}", "raw")
    m[f"{torch_prefix}.num_batches_tracked"] = (None, "skip")


def x3d_torch_key_map(cfg: Optional[X3DConfig] = None) -> Dict[str, tuple]:
    """Every key of a reference X3D state_dict -> (port key, kind), kind one
    of 'raw' (copied), 'pointwise' ((O, I, 1, 1, 1) -> [I, O]), 'dense'
    ((O, I) -> [I, O]) or 'skip' (port key None)."""
    cfg = cfg or x3d_l_config()
    m: Dict[str, tuple] = {
        "blocks.0.conv.conv_t.weight": ("stem.conv_s", "raw"),
        "blocks.0.conv.conv_xy.weight": ("stem.conv_t", "raw"),
    }
    _bn_keys(m, "blocks.0.norm", "stem.bn")
    for s in range(4):
        dim_in = cfg.stem_dim_out if s == 0 else cfg.stage_dims[s - 1]
        for j in range(cfg.stage_depths[s]):
            tp, pp = f"blocks.{s + 1}.res_blocks.{j}", f"stage{s + 1}.block{j}"
            if j == 0:
                m[f"{tp}.branch1_conv.weight"] = (f"{pp}.proj", "pointwise")
                if dim_in != cfg.stage_dims[s]:
                    _bn_keys(m, f"{tp}.branch1_norm", f"{pp}.proj_bn")
            tb, pb = f"{tp}.branch2", f"{pp}.bottleneck"
            m[f"{tb}.conv_a.weight"] = (f"{pb}.conv_a", "pointwise")
            _bn_keys(m, f"{tb}.norm_a", f"{pb}.bn_a")
            m[f"{tb}.conv_b.weight"] = (f"{pb}.conv_b", "raw")
            _bn_keys(m, f"{tb}.norm_b.0", f"{pb}.bn_b")
            if (j + 1) % 2:  # SE on even-indexed blocks
                for i, w in (("0", "reduce"), ("2", "expand")):
                    m[f"{tb}.norm_b.1.block.{i}.weight"] = (f"{pb}.se.w_{w}", "pointwise")
                    m[f"{tb}.norm_b.1.block.{i}.bias"] = (f"{pb}.se.b_{w}", "raw")
            m[f"{tb}.conv_c.weight"] = (f"{pb}.conv_c", "pointwise")
            _bn_keys(m, f"{tb}.norm_c", f"{pb}.bn_c")
    m["blocks.5.pool.pre_conv.weight"] = ("head.pre_conv", "pointwise")
    _bn_keys(m, "blocks.5.pool.pre_norm", "head.pre_bn")
    m["blocks.5.pool.post_conv.weight"] = ("head.post_conv", "pointwise")
    m["blocks.5.proj.weight"] = ("head.proj_w", "dense")
    m["blocks.5.proj.bias"] = ("head.proj_b", "raw")
    return m


def _numpy(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v,
                      dtype=np.float32)


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _convert_kind(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "pointwise":
        return a.reshape(a.shape[:2]).T
    if kind == "dense":
        return a.T
    return a


def convert_x3d_state_dict(state_dict: Mapping, cfg: Optional[X3DConfig] = None, *,
                           strict: bool = True) -> Dict[str, torch.Tensor]:
    """A reference (pytorchvideo-named) X3D state_dict -> the port's X3D
    state_dict keys (stem, stage1..4, plus ``head.*``), fp32 CPU tensors.
    Under ``strict`` an unmapped key or a missing one raises ValueError."""
    key_map = x3d_torch_key_map(cfg)
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for key, value in state_dict.items():
        if key not in key_map:
            unused.append(key)
            continue
        port_key, kind = key_map[key]
        if kind != "skip":
            out[port_key] = _tensor(_convert_kind(_numpy(value), kind))
    if strict:
        missing = [k for k, (_, kind) in key_map.items() if kind != "skip" and k not in state_dict]
        if missing:
            raise ValueError(f"Checkpoint missing {len(missing)} keys, e.g. {missing[:5]}")
        if unused:
            raise ValueError(f"Checkpoint has {len(unused)} unmapped keys, e.g. {unused[:5]}")
    return out


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def load_x3d_pretrained(path: str, cfg: Optional[X3DConfig] = None) -> Dict[str, torch.Tensor]:
    """Read a Kinetics X3D file (``X3D_L.pyth``, or ``X3D_M.pyth`` with
    ``x3d_m_config()``; its 'model_state' entry, or a bare state_dict) and
    convert it strictly (``convert_x3d_state_dict``): the state_dict of an
    ``X3D(cfg, head=True)``."""
    ckpt = _torch_load(path)
    return convert_x3d_state_dict(ckpt.get("model_state", ckpt), cfg)


def merge_backbone_variables(state_dict: Mapping[str, torch.Tensor],
                             backbone: Mapping[str, torch.Tensor], *,
                             drop_head: bool = True) -> Dict[str, torch.Tensor]:
    """``state_dict`` with every backbone entry taken from ``backbone``
    (``load_x3d_pretrained``'s output), ready for ``load_state_dict``: a
    Change3D model's ``encoder.x3d.*`` entries, or a bare X3D's (a state_dict
    with no ``encoder.x3d.`` key). Backbone stages the model does not build
    (stage 4 of the detection tasks) are left out, and with ``drop_head``
    the Kinetics head (the model keeps its own). Without ``drop_head`` the
    model must have the head (``X3D(cfg, head=True)``) and takes it. Raises
    ValueError if the backbone lacks one of the model's entries or has
    another shape."""
    out = dict(state_dict)
    prefix = "encoder.x3d." if any(k.startswith("encoder.x3d.") for k in state_dict) else ""
    wanted = {k[len(prefix):] for k in state_dict if k.startswith(prefix)}
    if drop_head:
        wanted = {k for k in wanted if not k.startswith("head.")}
    elif any(k.startswith("head.") for k in backbone) and not any(
            k.startswith("head.") for k in wanted):
        raise ValueError("the model has no Kinetics head to take the head's weights: "
                         "build X3D(cfg, head=True)")
    missing = sorted(wanted - set(backbone))
    if missing:
        raise ValueError(f"backbone lacks {len(missing)} of the model's entries, e.g. {missing[:5]}")
    for key in wanted:
        value = backbone[key]
        if tuple(value.shape) != tuple(state_dict[f"{prefix}{key}"].shape):
            raise ValueError(f"{prefix}{key}: backbone shape {tuple(value.shape)} vs model "
                             f"{tuple(state_dict[f'{prefix}{key}'].shape)}")
        out[f"{prefix}{key}"] = value
    return out


def _change_decoder_key(rest: str) -> Optional[tuple]:
    """Reference ChangeDecoder keys -> (port suffix, kind); every layout
    already matches the port's (OIHW convs, (I, O, kh, kw) transposed)."""
    parts = rest.split(".")
    if parts == ["up_c1", "0", "weight"]:
        return "final", "raw"
    if len(parts) == 3 and parts[0] in ("up_c4", "up_c3", "up_c2"):
        name = {("0", "weight"): "reduce", ("1", "weight"): "up",
                ("1", "bias"): "up_bias"}.get((parts[1], parts[2]))
        if name:
            return f"{parts[0]}.{name}", "raw"
    return None


# Submodules the reference's Mesh_TransformerDecoderLayer declares but its
# forward never runs (it uses self_attn / norm1 / multihead_attn2 / norm2).
_DEAD_CC_LAYER_PREFIXES = (
    "self_attn2.", "multihead_attn3.", "multihead_attn.", "linear1.", "linear2.", "norm3.",
    "fc_alpha1.", "fc_alpha2.", "fc_alpha3.",
)
_MHA_KEYS = {"in_proj_weight": ("in_proj_w", "dense"), "in_proj_bias": ("in_proj_b", "raw"),
             "out_proj.weight": ("out_w", "dense"), "out_proj.bias": ("out_b", "raw")}


def _caption_decoder_key(rest: str):
    """Reference CaptionDecoder keys -> (port suffix, kind), 'skip' or None.
    torch's fused in-projection (3E, E) becomes the port's [E, 3E] matrix
    (q | k | v columns, the same split)."""
    if rest == "vocab_embedding.weight":
        return "vocab_embedding", "raw"
    if rest in ("wdc.weight", "wdc.bias"):
        return ("out_w", "dense") if rest.endswith("weight") else ("out_b", "raw")
    if rest.startswith("position_encoding."):
        return "skip"  # the sinusoidal table is recomputed
    if not rest.startswith("transformer.layers."):
        return None
    _, _, layer, tail = rest.split(".", 3)
    for torch_mod, port_mod in (("self_attn.", "self_attn"), ("multihead_attn2.", "cross_attn")):
        if tail.startswith(torch_mod):
            hit = _MHA_KEYS.get(tail[len(torch_mod):])
            return (f"layer{layer}.{port_mod}.{hit[0]}", hit[1]) if hit else None
    if tail.startswith(_DEAD_CC_LAYER_PREFIXES):
        return "skip"
    for norm in ("norm1", "norm2"):
        if tail in (f"{norm}.weight", f"{norm}.bias"):
            return f"layer{layer}.{norm}.{'scale' if tail.endswith('weight') else 'bias'}", "raw"
    return None


_DETECTION_HEADS = ("decoder", "decoder_pre", "decoder_post", "decoder_change", "decoder_cls",
                    "decoder_loc")


def convert_trainer_state_dict(state_dict: Mapping, template: Mapping[str, torch.Tensor],
                               cfg: Optional[X3DConfig] = None, *,
                               strict: bool = True) -> Dict[str, torch.Tensor]:
    """A trained reference ``Trainer`` state_dict (its ``best_model.pth``, or
    ``checkpoint.pth.tar``'s 'state_dict') -> the port Change3D's state_dict.

    ``template`` (the target model's ``state_dict()``) fixes the result:
    converted entries the task never builds (stage 4 and the Kinetics head
    for detection, the enhancement convs for CC) are dropped. Under
    ``strict`` an unmapped key, a template entry left unfilled or a shape
    other than the template's raises ValueError."""
    backbone_sd, out, unknown = {}, {}, []
    for key, value in state_dict.items():
        if key.startswith("encoder.x3d."):
            backbone_sd[key[len("encoder.x3d."):]] = value
            continue
        a = _numpy(value)
        if key == "encoder.perception_frames":      # [1, 3, N, H, W] -> [1, N, H, W, 3]
            out[key] = _tensor(a.transpose(0, 2, 3, 4, 1))
            continue
        parts = key.split(".")
        if parts[:2] == ["encoder", "fc"] and parts[3:] == ["0", "weight"]:
            out[f"encoder.fc{parts[2]}.conv"] = _tensor(a[:, :, 0, 0].T)  # 1x1 conv -> [I, O]
            continue
        head, rest = key.split(".", 1) if "." in key else (key, "")
        conv = _change_decoder_key(rest) if head in _DETECTION_HEADS else None
        if conv is None and head == "decoder":
            conv = _caption_decoder_key(rest)
        if conv == "skip":
            continue
        if conv is None:
            unknown.append(key)
            continue
        out[f"{head}.{conv[0]}"] = _tensor(_convert_kind(a, conv[1]))
    for key, value in convert_x3d_state_dict(backbone_sd, cfg, strict=strict).items():
        out[f"encoder.x3d.{key}"] = value
    out = {k: v for k, v in out.items() if k in template}
    if strict:
        if unknown:
            raise ValueError(f"{len(unknown)} unmapped trainer keys, e.g. {unknown[:5]}")
        missing = sorted(set(template) - set(out))
        if missing:
            raise ValueError(f"missing {len(missing)} entries, e.g. {missing[:5]}")
        for k, v in out.items():
            if tuple(v.shape) != tuple(template[k].shape):
                raise ValueError(f"shape mismatch at {k}: {tuple(v.shape)} vs template "
                                 f"{tuple(template[k].shape)}")
    return out


def load_trainer_pretrained(path: str, template: Mapping[str, torch.Tensor],
                            cfg: Optional[X3DConfig] = None) -> Dict[str, torch.Tensor]:
    """Read a reference-trained checkpoint (a weights-only ``best_model.pth``
    or a ``checkpoint.pth.tar`` with a 'state_dict' entry) and convert it
    strictly (``convert_trainer_state_dict``)."""
    ckpt = _torch_load(path)
    state = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return convert_trainer_state_dict(state, template, cfg)
