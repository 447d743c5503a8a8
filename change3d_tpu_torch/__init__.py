"""PyTorch + CUDA port of change3d_tpu for one NVIDIA H100.

The JAX package ``change3d_tpu`` is the reference; this package imports none
of it (nor jax/flax, nor OpenCV). Public functions keep the JAX layouts:
activations [B, T, H, W, C], images [B, H, W, 3]. Weights are stored in
PyTorch's layouts (OIDHW / OIHW convs, (I, O, kh, kw) transposed convs)
except 1x1x1 convs and SE/FC weights, which stay [in, out] matrices so they
are plain matmuls.

Covered so far: the serving forward of the three detection tasks, BCD, SCD
and BDA (``inference.Predictor``), and change captioning (CC,
``inference.CaptionPredictor``: stages 1-4, the caption decoder and
KV-cached beam search), with the fused X3D bottleneck block as a
hand-written CUDA kernel (``csrc/fused_block.cu`` via ``ops.fused_block``),
the two Pallas repro kernels (``ops.repros``), and the training of all four
(``train.engine``, ``train.loop``, ``train.caption_loop``, ``python -m
change3d_tpu_torch.cli {bcd,scd,bda,cc}``), which evaluates through the
fused kernel.
"""
