"""Decoupled volume rendering: CUDA kernel + plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/volume_render.py``
``volume_render_call`` (``_vr_kernel``): Eq. (1) compositing of sigma and
delta per sample, with the §4.3 anchor colors expanded to every sample by
lerp.  The CUDA kernel (``csrc/volume_render.cu``, built by ``_build.py``
with nvcc for sm_90a) lerps the two enclosing anchors directly
(``core/decouple.py``'s rule) where the TPU kernel multiplies by a
constant expansion matrix, and carries the exclusive sum of sigma * delta
where the TPU kernel subtracts each sd from an inclusive cumsum (which
cancels once one sd dwarfs the prefix).  Bound on the H100: bytes.  A
warp takes ``RAYS`` consecutive rays and stages chunks of ``CHUNK``
samples of their sigma, delta and anchors through shared memory by
cp.async, double-buffered, so its loads coalesce; each lane then walks
its own ray.  ``volume_render_smem_bytes`` reckons the shared memory,
bounded whatever S and A are.

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
RAYS = 32          # rays per warp
WARPS = 2          # warps per CTA
CHUNK = 16         # samples per staged chunk
ROW_FLOATS = CHUNK + 4   # a ray's padded row of one chunk


def anchors_per_chunk(S: int, A: int, group: int) -> int:
    """Most anchors the samples of one chunk lerp between (lo and hi of
    each, clamped to A - 1), over the chunks of a ray of S samples."""
    most = 1
    for s0 in range(0, S, CHUNK):
        n = min(CHUNK, S - s0)
        lo = min(s0 // group, A - 1)
        hi = min((s0 + n - 1) // group + 1, A - 1)
        most = max(most, hi - lo + 1)
    return most


def anchor_row(na: int) -> int:
    """Floats of one ray's staged anchors: a run of ``na`` anchors from the
    16-B boundary at or below its start (up to 3 floats before it), in an
    odd number of float4s, so the 32 lanes' rows fall on distinct banks."""
    return 4 * ((3 * na + 6) // 4 | 1)


def volume_render_smem_bytes(S: int, A: int, group: int) -> int:
    """Dynamic shared memory of the kernel: per warp two buffers, each the
    sigma and delta rows of RAYS rays (ROW_FLOATS floats a ray) and their
    anchors (``anchor_row``), then RAYS floats of the lerp offsets
    m / group.  At most CHUNK + 1 anchors a chunk, so bounded."""
    arow = anchor_row(anchors_per_chunk(S, A, group))
    return 4 * WARPS * (2 * RAYS * (2 * ROW_FLOATS + arow) + RAYS)


def volume_render_launch_smem(S: int, A: int, group: int) -> int:
    """Bytes of shared memory the launcher asks for (the compiled
    library's own reckoning; builds it)."""
    fn = _build.library("volume_render").volume_render_smem
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn(S, A, group))


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
    _build.count_launch(volume_render)
    return out


volume_render.launches = 0
