"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit)."""

H100 = {
    "bf16_flops_per_s": 989e12,
    "fp32_flops_per_s": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}
