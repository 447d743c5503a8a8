"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default and is never
    silently replaced: without a card this raises unless the caller asks for
    ``device="cpu"`` (the plain PyTorch versions of every kernel).

    On CUDA, TF32 is switched off for matmuls and cuDNN convolutions, and
    cuBLAS may not reduce bf16 products in reduced precision: the plain paths
    are held against fp32 references, and TF32 keeps only ~3 decimal digits.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
