"""PyTorch/CUDA port of the ASDR renderer (the JAX package ``repro`` is the
reference and stays as it is).

Layout mirrors ``repro``: ``core/`` holds the plain-torch semantics,
``kernels/`` the hand-written CUDA kernels for Hopper with a plain
PyTorch version beside each, ``configs/`` the model bundles.  The port
imports ``torch`` and numpy only — never ``jax`` and nothing of ``repro``.

Importing the package sets the fp32 policy (``device.set_fp32_policy``):
TF32 off for matmuls and cuDNN, float32 matmul precision "highest".
"""
from .device import resolve_device, set_fp32_policy

set_fp32_policy()

__all__ = ["resolve_device", "set_fp32_policy"]
