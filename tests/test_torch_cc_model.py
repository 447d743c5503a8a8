"""CC model parity of change3d_tpu_torch against change3d_tpu on the CPU:
the encoder's ``output_final`` path, the CC Change3D's memory and
teacher-forced logits, the bridged CC tree (strict load, no ``encoder.fc*``,
TINY and X3D-L), and the seeded init's statistics. fp32 forwards within
1e-5 of the largest magnitude. The caption decoder runs with dropout 0 (the
two packages draw dropout from different streams).

The TINY backbone here has the widths of tests/_tiny_cc.py:TINY_KW with
stage depths (2, 3, 3, 3), so stage 4 holds a scanned pair and fused SE and
non-SE blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.models.encoder import Encoder as JaxEncoder
from change3d_tpu.models.trainer import Change3D as JaxChange3D, Task as JaxTask
from change3d_tpu.models.x3d import X3DConfig as JaxX3DConfig, x3d_l_config as jax_x3d_l_config
from change3d_tpu_torch.checkpoint.convert import from_jax_variables
from change3d_tpu_torch.models.encoder import Encoder
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import X3DConfig, x3d_l_config
from change3d_tpu_torch.ops import fused_block as fb

from tests._tiny_cc import TINY_KW

TINY_CC = dict(stem_dim_out=TINY_KW["stem_dim_out"], stage_dims=TINY_KW["stage_dims"],
               stage_inner_dims=TINY_KW["stage_inner_dims"], stage_depths=(2, 3, 3, 3))
HW, VOCAB, E, HEADS, LAYERS = 32, 11, 32, 4, 2
DECODER_KW = dict(vocab_size=VOCAB, embed_dim=E, num_heads=HEADS, num_layers=LAYERS, dropout=0.0)


def cfgs(fused: bool = True):
    """(JAX config, port config): the JAX side always on its plain blocks
    (its Pallas kernels are held in tests/test_torch_fused_block.py), the
    port's on the fused blocks' plain versions or on plain blocks."""
    return JaxX3DConfig(**TINY_CC), X3DConfig(**TINY_CC, fused_inference=fused)


def random_vars(init_fn, seed=0):
    """A variables tree from ``init_fn(key)``'s shapes (``jax.eval_shape``,
    no init is run) filled with seeded numpy values: kernels scaled by
    1/sqrt(fan_in), BN statistics, scales and biases away from their
    trivial init, the caption decoder's embedding and output at their init
    scale."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "var":
            return (1.0 + 0.5 * rng.rand(*shape)).astype(np.float32)
        if name in ("bias", "mean", "b_reduce", "b_expand", "up_bias", "in_proj_b", "out_b"):
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "perception_frames":
            return rng.randn(*shape).astype(np.float32)
        if name == "vocab_embedding":
            return rng.uniform(-0.1, 0.1, shape).astype(np.float32)
        stacked = any(getattr(p, "key", None) == "pairs" for p in path)
        fan_in = int(np.prod(shape[1 if stacked else 0:-1]))
        return (rng.uniform(-1, 1, shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_cc(jcfg, hw=HW, **kw):
    return JaxChange3D(task=JaxTask.CC, in_height=hw, in_width=hw, backbone_cfg=jcfg,
                       **dict(DECODER_KW, **kw))


def cc_pair(fused=True, seed=0, hw=HW, **kw):
    """A JAX CC Change3D, a seeded variables tree, and the port's model
    with the bridged tree loaded strictly (eval mode, on the CPU)."""
    jcfg, cfg = cfgs(fused)
    jmodel = jax_cc(jcfg, hw, **kw)
    z = jnp.zeros((1, hw, hw, 3), jnp.float32)
    variables = random_vars(lambda key: jmodel.init(key, z, z, captions=jnp.zeros((1, 4),
                                                                                 jnp.int32)),
                            seed)
    model = Change3D(Task.CC, in_height=hw, in_width=hw, backbone_cfg=cfg, device="cpu",
                     **dict(DECODER_KW, **kw))
    model.load_state_dict(from_jax_variables(variables, cfg), strict=True)
    return jmodel, variables, model.eval()


def close(got, want, rel=1e-5, msg=""):
    """|got - want| <= rel * max|want|, elementwise."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, f"{msg}: max |d| {err} > {rel} * {scale}"


def images(seed, b=2, hw=HW):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, hw, hw, 3).astype(np.float32) for _ in range(2))


def captions(seed, b=2, length=9, vocab=VOCAB):
    rs = np.random.RandomState(seed)
    caps = np.zeros((b, length), np.int32)
    for i in range(b):
        n = rs.randint(3, length)
        caps[i, 0], caps[i, 1:n - 1], caps[i, n - 1] = 2, rs.randint(4, vocab, n - 2), 3
    return caps


@pytest.mark.parametrize("fused", [False, True])
def test_encoder_output_final_matches_jax(fused):
    jcfg, cfg = cfgs(fused)
    pre, post = images(1)
    jenc = JaxEncoder(num_perception_frames=1, in_height=HW, in_width=HW, cfg=jcfg)
    variables = random_vars(lambda key: jenc.init(key, jnp.asarray(pre), jnp.asarray(post),
                                                  output_final=True))
    assert not any(k.startswith("fc") for k in variables["params"])
    want = jenc.apply(variables, jnp.asarray(pre), jnp.asarray(post), output_final=True)
    enc = Encoder(1, HW, HW, cfg, generator=torch.Generator().manual_seed(0), output_final=True)
    enc.load_state_dict(from_jax_variables(variables, cfg), strict=True)
    before = fb.fused_block_fwd.launches
    with torch.no_grad():
        got = enc.eval()(torch.from_numpy(pre), torch.from_numpy(post))
    assert got.shape == (2, HW // 16, HW // 16, TINY_CC["stage_dims"][3])
    close(got, want, msg="stage-4 feature")
    assert fb.fused_block_fwd.launches == before  # CPU tensors take the plain version


@pytest.mark.parametrize("fused", [False, True])
def test_cc_memory_and_logits_match_jax(fused):
    jmodel, variables, model = cc_pair(fused)
    pre, post = images(2)
    caps = captions(3)
    want = jmodel.apply(variables, jnp.asarray(pre), jnp.asarray(post),
                        captions=jnp.asarray(caps), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(pre), torch.from_numpy(post), torch.from_numpy(caps))
    assert set(got) == {"memory", "logits"}
    close(got["memory"], want["memory"], msg="memory")
    close(got["logits"], want["logits"], msg="logits")
    with torch.no_grad():
        assert set(model(torch.from_numpy(pre), torch.from_numpy(post))) == {"memory"}


def test_cc_decode_surface_matches_jax():
    """decode_captions, precompute_memory_kv and one decode_captions_step
    against the JAX methods on the bridged model."""
    jmodel, variables, model = cc_pair(True, seed=4)
    rs = np.random.RandomState(5)
    memory = rs.randn(2, 4, E).astype(np.float32)
    tokens = captions(6)
    want = jmodel.apply(variables, jnp.asarray(tokens), jnp.asarray(memory),
                        method=jmodel.decode_captions)
    mem_t = torch.from_numpy(memory)
    with torch.no_grad():
        close(model.decode_captions(torch.from_numpy(tokens), mem_t), want, msg="decode")
        kv = model.precompute_memory_kv(mem_t)
        cache = model.init_decode_cache(2, tokens.shape[1])
        step_logits, _ = model.decode_captions_step(torch.from_numpy(tokens[:, 0]), kv, cache, 0)
    jkv = jmodel.apply(variables, jnp.asarray(memory), method=jmodel.precompute_memory_kv)
    for (k, v), (jk, jv) in zip(kv, jkv):
        close(k, jk, msg="memory k")
        close(v, jv, msg="memory v")
    jcache = jmodel.apply(variables, 2, tokens.shape[1], None, method=jmodel.init_decode_cache)
    jstep, _ = jmodel.apply(variables, jnp.asarray(tokens[:, 0]), jkv, jcache, 0,
                            method=jmodel.decode_captions_step)
    close(step_logits, jstep, msg="decode step")
    close(step_logits, want[:, 0], msg="decode step vs column 0")


def test_bridged_cc_tree_loads_strictly_on_tiny_and_x3d_l():
    """The JAX CC tree (stage 4 scanned in pairs at X3D-L depth, the
    caption decoder) bridges to a state_dict that loads strictly; neither
    side has encoder.fc*, nothing of the decoder is transposed."""
    for jcfg, cfg, hw in ((*cfgs(), HW), (jax_x3d_l_config(), x3d_l_config(), 64)):
        jmodel = jax_cc(jcfg, hw, vocab_size=13, embed_dim=cfg.stage_dims[3], num_heads=8,
                        num_layers=3)
        z = jnp.zeros((1, hw, hw, 3), jnp.float32)
        shapes = jax.eval_shape(lambda key: jmodel.init(key, z, z, captions=jnp.zeros(
            (1, 4), jnp.int32)), jax.random.PRNGKey(0))
        assert "pairs" in shapes["params"]["encoder"]["x3d"]["stage4"]
        variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
        sd = from_jax_variables(variables, cfg)
        assert not any(k.startswith("encoder.fc") for k in sd)
        assert sd["decoder.layer0.self_attn.in_proj_w"].shape == (cfg.stage_dims[3],
                                                                  3 * cfg.stage_dims[3])
        assert sd["decoder.out_w"].shape == (cfg.stage_dims[3], 13)
        model = Change3D(Task.CC, in_height=hw, in_width=hw, backbone_cfg=cfg, device="cpu",
                         vocab_size=13, embed_dim=cfg.stage_dims[3], num_heads=8, num_layers=3)
        model.load_state_dict(sd, strict=True)
        assert set(model.state_dict()) == set(sd)
        depth4 = cfg.stage_depths[3]
        assert f"encoder.x3d.stage4.block{depth4 - 1}.bottleneck.conv_a" in sd


def test_cc_seeded_init_follows_the_jax_distributions():
    """A seeded port CC model has every parameter of the JAX init under the
    same name and shape with the same distribution: the same constant, or a
    std within 20% (the decoder's uniform(-0.1, 0.1), Xavier and Kaiming
    inits included)."""
    jcfg, cfg = cfgs(False)
    jmodel = jax_cc(jcfg, vocab_size=300, num_heads=4, num_layers=2)
    z = jnp.zeros((1, HW, HW, 3), jnp.float32)
    init = jax.jit(lambda key: jmodel.init(key, z, z, captions=jnp.zeros((1, 4), jnp.int32)))
    want = from_jax_variables(jax.device_get(init(jax.random.PRNGKey(0))), cfg)
    got = Change3D(Task.CC, in_height=HW, in_width=HW, backbone_cfg=cfg, device="cpu",
                   vocab_size=300, embed_dim=E, num_heads=4, num_layers=2).state_dict()
    assert set(got) == set(want)
    checked = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if float(w.std()) == 0:
            assert torch.equal(g, w), k
        elif w.numel() >= 256:
            assert 0.8 < float(g.std() / w.std()) < 1.25, k
            checked += k.startswith("decoder.")
    assert checked >= 7  # embedding, output, and each layer's attention matrices
    assert float(got["decoder.vocab_embedding"].abs().max()) <= 0.1


def test_cc_needs_a_vocabulary():
    with pytest.raises(ValueError, match="vocab_size"):
        Change3D(Task.CC, in_height=HW, in_width=HW, backbone_cfg=cfgs()[1], device="cpu")


def test_dropout_is_active_in_train_mode_and_off_at_eval():
    """With dropout 0.1 the train-mode logits depend on the generator's
    draw and differ from eval; eval ignores the generator."""
    _, cfg = cfgs(False)
    model = Change3D(Task.CC, in_height=HW, in_width=HW, backbone_cfg=cfg, device="cpu",
                     **dict(DECODER_KW, dropout=0.1))
    memory = torch.randn(2, 4, E, generator=torch.Generator().manual_seed(0))
    caps = torch.from_numpy(captions(7))
    dec = model.decoder
    run = lambda seed: dec(memory, caps, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        dec.eval()
        e1, e2 = run(1), run(2)
        dec.train()
        t1, t1b, t2 = run(1), run(1), run(2)
    assert torch.equal(e1, e2)
    assert torch.equal(t1, t1b) and not torch.equal(t1, t2) and not torch.equal(t1, e1)
