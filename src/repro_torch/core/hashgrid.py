"""Multi-resolution hash-grid encoding (Instant-NGP) with ASDR's level-split
layout (``repro.core.hashgrid``).

A level is "dense" when ``(res+1)^3 <= table_size``: dense levels index
their table row-major (the paper's de-hashed low-resolution levels),
finer levels use Instant-NGP's spatial hash (Eq. 2).  The hash is
wrapping uint32 arithmetic; torch has no uint32 multiply, so it runs in
int64 and masks to 32 bits after every product.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Instant-NGP's hash primes (Eq. 2 of the ASDR paper / Müller et al. 2022).
PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


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

    def level_is_dense(self, level: int) -> bool:
        res = self.level_resolution(level)
        return (res + 1) ** 3 <= self.table_size

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.feature_dim


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
    for c in range(8):
        off = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
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
