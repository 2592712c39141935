"""Decoupled volume rendering: CUDA kernel + plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/volume_render.py``
``volume_render_call`` (``_vr_kernel``): Eq. (1) compositing of sigma and
delta per sample, with the §4.3 anchor colors expanded to every sample by
lerp.  The CUDA kernel (``csrc/volume_render.cu``, built by ``_build.py``
with nvcc for sm_90a) takes one ray per thread and lerps the two
enclosing anchors directly (``core/decouple.py``'s rule) where the TPU
kernel multiplies by a constant expansion matrix, and carries the
exclusive sum of sigma * delta where the TPU kernel subtracts each sd from
an inclusive cumsum (which cancels once one sd dwarfs the prefix).  Bound
on the H100: bytes.

Output rows (R, 4): [acc, r, g, b], before any background.

``volume_render`` launches the kernel for CUDA tensors and uses
``volume_render_plain`` only for tensors on the CPU.  The plain version
walks the samples in the kernel's order with the kernel's arithmetic, so
on the card the two agree to the bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

OUT_W = 4


def volume_render_plain(sigmas, deltas, anchors, group: int):
    """sigmas/deltas (R, S), anchors (R, A, 3) -> (R, 4) [acc, rgb]."""
    R, S = sigmas.shape
    A = anchors.shape[1]
    dev = sigmas.device
    excl = torch.zeros((R,), device=dev)
    acc = torch.zeros((R,), device=dev)
    rgb = torch.zeros((R, 3), device=dev)
    for j in range(S):
        sd = sigmas[:, j] * deltas[:, j]
        w = torch.exp(-excl) * (1.0 - torch.exp(-sd))
        excl = excl + sd
        acc = acc + w
        t = float(np.float32(j % group) / np.float32(group))
        lo = anchors[:, min(j // group, A - 1)]
        hi = anchors[:, min(j // group + 1, A - 1)]
        rgb = rgb + w[:, None] * (lo + (hi - lo) * t)
    return torch.cat([acc[:, None], rgb], dim=1)


def volume_render(sigmas, deltas, anchors, group: int):
    """sigmas/deltas (R, S), anchors (R, A, 3) fp32 -> (R, 4) [acc, rgb].
    CUDA tensors launch the kernel."""
    if sigmas.device.type == "cpu":
        return volume_render_plain(sigmas, deltas, anchors, group)
    dev = sigmas.device
    _build.require("volume_render sigmas", sigmas, torch.float32, 2, dev)
    _build.require("volume_render deltas", deltas, torch.float32, 2, dev)
    _build.require("volume_render anchors", anchors, torch.float32, 3, dev)
    R, S = sigmas.shape
    A = anchors.shape[1]
    if (deltas.shape != sigmas.shape or tuple(anchors.shape) != (R, A, 3)
            or A < 1 or group < 1):
        raise ValueError(
            f"volume_render: sigmas {tuple(sigmas.shape)}, deltas "
            f"{tuple(deltas.shape)}, anchors {tuple(anchors.shape)}, "
            f"group {group}")
    out = torch.empty((R, OUT_W), dtype=torch.float32, device=dev)
    fn = _build.library("volume_render").volume_render_launch
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = [P, P, P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, P, P]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(sigmas.data_ptr(), deltas.data_ptr(), anchors.data_ptr(), R,
                 S, A, group, out.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "volume_render")
    volume_render.launches += 1
    return out


volume_render.launches = 0
