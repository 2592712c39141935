"""Multi-resolution hash-grid encode: CUDA kernel + plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/hash_encode.py``
(``hash_encode_call`` / ``_encode_kernel`` / ``encode_level``).  The CUDA
kernel (``csrc/hash_encode.cu``, built by ``_build.py`` with nvcc for
sm_90a) runs one thread per (point, level) and writes the (N, L*F) layout
directly.  Bound on the H100: bytes — random table gathers from a 64 MiB
stack that does not fit the 50 MB L2.

``hash_encode`` launches the kernel for CUDA tensors and uses
``hash_encode_plain`` only for tensors on the CPU.  The plain version is
``core.hashgrid.encode_level``, which repeats the kernel's arithmetic op
by op (same corner order, same rounding), so on the card the two agree
to the bit.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import hashgrid
from . import _build

MAX_FEAT = 8


def grid_meta(cfg, device=None) -> torch.Tensor:
    """(L, 3) int32 rows [res, is_dense, table_rows] of a HashGridConfig."""
    rows = [[cfg.level_resolution(l), int(cfg.level_is_dense(l)),
             cfg.table_size] for l in range(cfg.n_levels)]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def hash_encode_plain(points, meta, tables):
    """points (N, 3), meta (L, 3) int32, tables (L, T, F) -> (N, L*F), by
    ``core.hashgrid.encode_level`` (the kernel's arithmetic op by op)."""
    rows = {r for _, _, r in meta.tolist()}
    if rows != {tables.shape[1]}:
        raise ValueError(f"meta rows {rows} != table rows {tables.shape[1]}")
    return torch.cat([hashgrid.encode_level(points, tables[l], res, bool(dense))
                      for l, (res, dense, _) in enumerate(meta.tolist())],
                     dim=-1)


def _lib():
    lib = _build.library("hash_encode")
    fn = lib.hash_encode_launch
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, LL, P, P, I, LL, I, P, P]
        fn.restype = ctypes.c_int
    return fn


def hash_encode(points, meta, tables):
    """points (N, 3) f32, meta (L, 3) i32, tables (L, T, F) f32 ->
    encoding (N, L*F) f32.  CUDA tensors launch the kernel."""
    if points.device.type == "cpu":
        return hash_encode_plain(points, meta, tables)
    dev = points.device
    _build.require("hash_encode points", points, torch.float32, 2, dev)
    _build.require("hash_encode meta", meta, torch.int32, 2, dev)
    _build.require("hash_encode tables", tables, torch.float32, 3, dev)
    L, T, F = tables.shape
    if points.shape[1] != 3 or tuple(meta.shape) != (L, 3) or F > MAX_FEAT:
        raise ValueError(f"hash_encode: points {tuple(points.shape)}, meta "
                         f"{tuple(meta.shape)}, F={F} (kernel takes F <= "
                         f"{MAX_FEAT})")
    n = points.shape[0]
    out = torch.empty((n, L * F), dtype=torch.float32, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        err = fn(points.data_ptr(), n, meta.data_ptr(), tables.data_ptr(),
                 L, T, F, out.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "hash_encode")
    hash_encode.launches += 1
    return out


hash_encode.launches = 0
