"""CC with an int8 encoder on the CPU: the dynamic int8 encoder's tokens
at beam 1 equal the JAX package's on the bridged TINY CC model (2 x 11
int8 products per forward, the fused blocks off), and ``cli predict`` /
``eval --model_task cc`` refuse the static regime in JAX's words."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.inference import CaptionPredictor as JaxCaptionPredictor
from change3d_tpu.models.x3d import X3DConfig as JaxX3DConfig
from change3d_tpu_torch import cli
from change3d_tpu_torch.checkpoint.convert import from_jax_variables
from change3d_tpu_torch.inference import CaptionPredictor
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import X3DConfig
from change3d_tpu_torch.ops import quant

from tests._torch_parallel import few_threads  # noqa: F401 (autouse)
from tests.test_torch_cc_model import HW, TINY_CC, cc_pair
from tests.test_torch_cc_predict import WORDS


def test_cc_takes_dynamic_int8_only():
    for sub, words in (("predict", "cc predict supports dynamic int8 only"),
                       ("eval", "cc eval supports dynamic int8 only (static calibration is "
                                "wired for the detection tasks)")):
        argv = [sub, "--model_task", "cc", "--checkpoint", "c", "--file_root", "f",
                "--quantized", "--quant_mode", "static", "--device", "cpu"]
        if sub == "predict":
            argv += ["--out", "o"]
        with pytest.raises(SystemExit, match=words.replace("(", r"\(").replace(")", r"\)")):
            cli.main(argv)


def test_cc_dynamic_int8_tokens_match_jax():
    jmodel, variables, _ = cc_pair(True, seed=13)
    variables["params"]["decoder"]["out_b"][3] -= 2.0
    variables["params"]["decoder"]["out_w"][:, 3] *= 3.0
    jmodel = jmodel.clone(backbone_cfg=JaxX3DConfig(**TINY_CC, quantized_eval=True))
    cfg = X3DConfig(**TINY_CC, quantized_eval=True)
    model = Change3D(Task.CC, in_height=HW, in_width=HW, backbone_cfg=cfg, device="cpu",
                     vocab_size=len(WORDS), embed_dim=32, num_heads=4, num_layers=2, dropout=0.0)
    model.load_state_dict(from_jax_variables(variables, cfg), strict=True)
    rs = np.random.RandomState(14)
    pre, post = (rs.randint(0, 256, (2, HW, HW, 3)).astype(np.uint8) for _ in range(2))
    before = quant.int8_matmul.launches
    got = CaptionPredictor(model, WORDS, compute_dtype=torch.float32,
                           device="cpu").caption_u8(pre, post)
    assert quant.int8_matmul.launches - before == 2 * sum(TINY_CC["stage_depths"])
    want = JaxCaptionPredictor(jmodel, variables, WORDS, beam_size=1,
                               compute_dtype=jnp.float32).caption_u8(pre, post)
    assert got == want and all(got)
