"""Multi-resolution hash-grid encoding (Instant-NGP) with ASDR's level-split
layout (``repro.core.hashgrid``).

A level is "dense" when ``(res+1)^3 <= table_size``: dense levels index
their table row-major (the paper's de-hashed low-resolution levels),
finer levels use Instant-NGP's spatial hash (Eq. 2).  The hash is
wrapping uint32 arithmetic; torch has no uint32 multiply, so it runs in
int64 and masks to 32 bits after every product.

``level_voxel_ids`` keeps true int64 ids.  The reference asks for int64
but runs without 64-bit mode, so its ids are int32 and wrap once
``res^3`` passes 2^31 (the finest levels of the paper's config, res
~1,300 and up); below that the two agree exactly, above it mod 2^32.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import prng
from ..device import resolve_device

# Instant-NGP's hash primes (Eq. 2 of the ASDR paper / Müller et al. 2022).
PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
# The 8 corners of a unit voxel, c -> (c>>2, c>>1 & 1, c & 1): the
# reference's order.
CORNERS = tuple(((c >> 2) & 1, (c >> 1) & 1, c & 1) for c in range(8))


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    log2_table_size: int = 19
    feature_dim: int = 2
    base_resolution: int = 16
    max_resolution: int = 2048

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def growth_factor(self) -> float:
        if self.n_levels == 1:
            return 1.0
        return float(
            np.exp(
                (np.log(self.max_resolution) - np.log(self.base_resolution))
                / (self.n_levels - 1)
            )
        )

    def level_resolution(self, level: int) -> int:
        return int(np.floor(self.base_resolution * self.growth_factor**level))

    def level_resolutions(self) -> Tuple[int, ...]:
        return tuple(self.level_resolution(l) for l in range(self.n_levels))

    def level_is_dense(self, level: int) -> bool:
        res = self.level_resolution(level)
        return (res + 1) ** 3 <= self.table_size

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.feature_dim


def init_hashgrid(cfg: HashGridConfig, key,
                  device=None) -> torch.Tensor:
    """Uniform(-1e-4, 1e-4) tables, as in Instant-NGP: one stacked
    ``(n_levels, table_size, feature_dim)`` float32 tensor on ``device``
    (the GPU unless ``device="cpu"``), ``prng.uniform(key, ...)``: the
    reference's tables for the same key.  Dense levels use only their
    first ``(res+1)^3`` rows (``storage_utilization``)."""
    dev = resolve_device(device)
    shape = (cfg.n_levels, cfg.table_size, cfg.feature_dim)
    return prng.uniform(key, shape, minval=-1e-4, maxval=1e-4, device=dev)


def level_indices(coords: torch.Tensor, res: int, dense: bool,
                  table_size: int) -> torch.Tensor:
    """Integer vertex coords (..., 3) -> table row indices (...,) int64."""
    coords = coords.to(torch.int64)
    if dense:
        stride = res + 1
        return coords[..., 0] + stride * (coords[..., 1] + stride * coords[..., 2])
    h = (coords[..., 0] * PRIMES[0]) & _U32
    h = h ^ ((coords[..., 1] * PRIMES[1]) & _U32)
    h = h ^ ((coords[..., 2] * PRIMES[2]) & _U32)
    return h % table_size


def encode_level(points: torch.Tensor, table: torch.Tensor, res: int,
                 dense: bool) -> torch.Tensor:
    """Encode points (N, 3) in [0,1]^3 against one level's table (T, F).

    The 8 corners c = (c>>2, c>>1 & 1, c & 1) are blended in order, each
    weight the product wx*wy*wz: the CUDA kernel's arithmetic op by op, so
    this is also the hash-encode kernel's plain version."""
    scaled = points * float(res)
    base = torch.clamp(torch.floor(scaled).to(torch.int64), 0, res - 1)
    frac = scaled - base.to(points.dtype)
    acc = torch.zeros((points.shape[0], table.shape[-1]), dtype=points.dtype,
                      device=points.device)
    for off in CORNERS:
        idx = level_indices(base + torch.tensor(off, device=points.device),
                            res, dense, table.shape[0])
        wx, wy, wz = (frac[:, k] if off[k] else 1.0 - frac[:, k]
                      for k in range(3))
        acc = acc + table[idx] * (wx * wy * wz)[:, None]
    return acc


def encode(points: torch.Tensor, tables: torch.Tensor,
           cfg: HashGridConfig) -> torch.Tensor:
    """Full multi-resolution encoding: (N, 3) -> (N, n_levels * feature_dim)."""
    return torch.cat([
        encode_level(points, tables[l], cfg.level_resolution(l),
                     cfg.level_is_dense(l))
        for l in range(cfg.n_levels)], dim=-1)


def level_voxel_ids(points: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """(N, 3) -> (N, n_levels) int64: the row-major id of the voxel holding
    each point at each level (not the hash: two points share an id iff
    they fall in the same cube, the paper's Fig. 15)."""
    ids = []
    for l in range(cfg.n_levels):
        res = cfg.level_resolution(l)
        base = torch.clamp(torch.floor(points * float(res)).to(torch.int64),
                           0, res - 1)
        ids.append(base[:, 0] + res * (base[:, 1] + res * base[:, 2]))
    return torch.stack(ids, dim=-1)


def storage_utilization(cfg: HashGridConfig) -> dict:
    """The table rows each layout uses, as a share of ``n_levels`` full
    tables (the paper's Fig. 13): "naive" hashes every level into a full
    table, so a dense level touches only its ``(res+1)^3`` rows; "hybrid"
    stores a dense level exactly and fills the table with
    ``copies_per_level`` replicas of it."""
    T = cfg.table_size
    naive_used = hybrid_used = 0
    copies = {}
    for l in range(cfg.n_levels):
        dense_size = (cfg.level_resolution(l) + 1) ** 3
        if dense_size <= T:
            copies[l] = max(1, T // dense_size)
            naive_used += dense_size
            hybrid_used += copies[l] * dense_size
        else:
            copies[l] = 1
            naive_used += T
            hybrid_used += T
    total = cfg.n_levels * T
    return {"naive_utilization": naive_used / total,
            "hybrid_utilization": hybrid_used / total,
            "copies_per_level": copies}
