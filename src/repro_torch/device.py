"""Device resolution and the fp32 numerics policy.

Entry points take ``device=None``, which means the GPU: they run on
``cuda`` unless the caller passes ``device="cpu"`` (as the CPU tests do).
Without a GPU and without ``device="cpu"`` they raise; nothing falls back
to the CPU on its own.
"""
from __future__ import annotations

import torch


def set_fp32_policy() -> None:
    """Full-precision float32 everywhere: no TF32 in matmuls or cuDNN
    convolutions, matmul precision "highest".  The port's parity contract
    against the JAX reference (rtol 1e-4) is stated in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if the resolved device is CUDA and no GPU
    is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions")
    return dev
