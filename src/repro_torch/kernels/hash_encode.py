"""Multi-resolution hash-grid encode: CUDA kernel + plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/hash_encode.py:94``
(``hash_encode_call`` / ``_encode_kernel`` / ``encode_level``).  Bound
on the H100: bytes, of random gathers, eight table rows per (point,
level) from a table stack (64 MiB at the paper's config) larger than the
50 MB L2, while the (N, L*F) output streams through it.

The CUDA kernel (``csrc/hash_encode.cu``, built by ``_build.py`` with
nvcc for sm_90a) walks the work level-group-major, as the TPU kernel's
grid walks it level-major: a work item is one point at a group of
``levels_per_group(F)`` consecutive levels (32 B of output at F = 2, one
whole sector, stored with an evict-first hint), and item i is point i % n
of group i // n (``work_items``).  So the resident CTAs sweep all points
of one level group before the next, and at most two groups' tables are
live in L2 at once.  ``LANES_PER_POINT`` lanes share a work item, one
per x-neighbour of the cell, so a warp gathers for 16 consecutive
(ray-ordered) points at one level, both x-corners of a point in one load;
the lane holding the first four corners' sums hands them to the other,
which adds its four in order.  ``warp_sectors`` counts the distinct
sectors a warp's gathers touch under that mapping and under the
point-major one it replaced.

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
# Floats of one work item's output and lanes a point: kGroupFloats and
# kLanesPerPoint of csrc/hash_encode.cu.
GROUP_FLOATS = 8
LANES_PER_POINT = 2
WARP = 32
SECTOR = 32          # bytes


def grid_meta(cfg, device=None) -> torch.Tensor:
    """(L, 3) int32 rows [res, is_dense, table_rows] of a HashGridConfig."""
    rows = [[cfg.level_resolution(l), int(cfg.level_is_dense(l)),
             cfg.table_size] for l in range(cfg.n_levels)]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def levels_per_group(F: int) -> int:
    """G: the consecutive levels of one work item at feature width F, so
    that it writes GROUP_FLOATS floats (one 32-B sector at F = 2)."""
    return max(1, GROUP_FLOATS // F)


def work_items(n: int, L: int, F: int) -> list:
    """The kernel's level groups in the order it walks them, [(group,
    first_level, levels)] (none for n = 0).  Work item i is point i % n
    of group i // n; a warp takes 32 / LANES_PER_POINT consecutive
    items."""
    if n <= 0:
        return []
    G = levels_per_group(F)
    return [(g, l0, min(G, L - l0)) for g, l0 in enumerate(range(0, L, G))]


def _warp_of(p, level: int, n: int, L: int, F: int, mapping: str):
    """The warp that encodes point ``p`` at ``level`` under ``mapping``."""
    if mapping == "point":
        return (p * L + level) // WARP
    item = (level // levels_per_group(F)) * n + p
    return item * LANES_PER_POINT // WARP


def warp_sectors(points, meta, F: int, mapping: str = "level",
                 chunk: int = 1 << 20) -> torch.Tensor:
    """(L,) int64: per level, the distinct 32-B sectors that the warps'
    corner gathers touch, summed over warps, for ``points`` (N, 3) in the
    order given.  ``mapping`` "level" is this kernel's (``work_items``);
    "point" the point-major one it replaced (thread t encodes point t // L
    at level t % L).  Each level's table is taken to start on a sector.
    Runs in chunks of ``chunk`` points (a multiple of 32)."""
    if mapping not in ("level", "point"):
        raise ValueError(f"mapping {mapping!r} is 'level' or 'point'")
    n, L = points.shape[0], meta.shape[0]
    corners = torch.tensor([[(c >> 2) & 1, (c >> 1) & 1, c & 1]
                            for c in range(8)], device=points.device)
    counts = torch.zeros(L, dtype=torch.int64)
    for level, (res, dense, rows) in enumerate(meta.tolist()):
        n_sec = -(-rows * F * 4 // SECTOR)
        # chunks start where warps do, so no warp is split between two
        first = 0 if mapping == "point" else (
            -(level // levels_per_group(F)) * n) % (WARP // LANES_PER_POINT)
        bounds = sorted({0, n} | set(range(first, n, chunk)))
        for s, e in zip(bounds[:-1], bounds[1:]):
            p = torch.arange(s, e, device=points.device)
            base = torch.clamp(torch.floor(points[s:e] * float(res)).to(
                torch.int64), 0, res - 1)
            idx = hashgrid.level_indices(base[:, None, :] + corners, res,
                                         bool(dense), rows)
            key = (_warp_of(p, level, n, L, F, mapping)[:, None] * n_sec
                   + idx * (F * 4) // SECTOR)
            counts[level] += torch.unique(key).numel()
    return counts


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
        fn.argtypes = [P, LL, P, P, I, LL, I, I, P, P]
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
                 L, T, F, levels_per_group(F), out.data_ptr(),
                 _build.stream_ptr(dev))
    _build.check(err, "hash_encode")
    hash_encode.launches += 1
    return out


hash_encode.launches = 0
