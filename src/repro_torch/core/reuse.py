"""Locality profiles and the cache simulation of the paper's Figs. 4, 8,
15 and 22 (§5.2.2) (``repro.core.reuse``).

The profiles that take points compute voxel ids and table addresses on
``device`` (the GPU unless ``device="cpu"``) and return numpy arrays;
the counting, the LRU simulation and the colour cosines run on the host
in numpy, as the reference's do.  Table addresses are int64 here (the
reference's are int32; the values are the same).  Voxel ids are true
int64 (``hashgrid.level_voxel_ids``), where the reference's wrap at the
paper's finest level, so two voxels it conflates stay apart here.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import hashgrid


def _points(points, device) -> torch.Tensor:
    return torch.as_tensor(points, dtype=torch.float32,
                           device=resolve_device(device))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def hash_address_trace(points, cfg: hashgrid.HashGridConfig, level: int,
                       device=None) -> np.ndarray:
    """(N, 8) table rows of the 8 corners of each point at ``level``, in
    access order (Fig. 4)."""
    pts = _points(points, device)
    res = cfg.level_resolution(level)
    base = torch.clamp(torch.floor(pts * float(res)).to(torch.int64), 0,
                       res - 1)
    corners = base[:, None, :] + torch.tensor(hashgrid.CORNERS,
                                                device=pts.device)
    return _host(hashgrid.level_indices(corners, res,
                                        cfg.level_is_dense(level),
                                        cfg.table_size))


def adjacent_color_cosine(colors) -> np.ndarray:
    """Flat cosine similarities of the colours of adjacent samples along
    rays; colors (R, S, 3) (Fig. 8: most of the mass near 1)."""
    c = _host(colors)
    a, b = c[:, :-1], c[:, 1:]
    num = (a * b).sum(-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-9
    return (num / den).reshape(-1)


def inter_ray_repetition(points_a, points_b, cfg: hashgrid.HashGridConfig,
                         device=None) -> np.ndarray:
    """(n_levels,): the share of ray b's samples (S, 3) whose voxel at each
    level also holds a sample of ray a (Fig. 15a)."""
    ids_a = _host(hashgrid.level_voxel_ids(_points(points_a, device), cfg))
    ids_b = _host(hashgrid.level_voxel_ids(_points(points_b, device), cfg))
    return np.asarray([np.isin(ids_b[:, l], ids_a[:, l]).mean()
                       for l in range(cfg.n_levels)])


def intra_ray_max_voxel_count(points, cfg: hashgrid.HashGridConfig,
                              device=None) -> np.ndarray:
    """(n_levels,): the most samples of one ray sharing a voxel (Fig. 15b)."""
    ids = _host(hashgrid.level_voxel_ids(_points(points, device), cfg))
    return np.asarray([np.unique(ids[:, l], return_counts=True)[1].max()
                       for l in range(cfg.n_levels)])


def lru_cache_hit_rate(addresses: np.ndarray, cache_items: int) -> float:
    """Hit rate of a per-table LRU cache of ``cache_items`` rows over the
    flat address stream (the paper's register cache, Fig. 22)."""
    if cache_items <= 0:
        return 0.0
    cache: OrderedDict = OrderedDict()
    hits = 0
    for a in addresses.reshape(-1).tolist():
        if a in cache:
            hits += 1
            cache.move_to_end(a)
        else:
            cache[a] = True
            if len(cache) > cache_items:
                cache.popitem(last=False)
    return hits / max(addresses.size, 1)


def cache_sweep(points, cfg: hashgrid.HashGridConfig,
                sizes: Sequence[int] = (0, 2, 4, 8, 16, 32),
                device=None) -> Dict[int, np.ndarray]:
    """{cache size: (n_levels,) hit rates} (Fig. 22's shape)."""
    traces = [hash_address_trace(points, cfg, l, device)
              for l in range(cfg.n_levels)]
    return {s: np.asarray([lru_cache_hit_rate(tr, s) for tr in traces])
            for s in sizes}


def dedup_window_rate(points, cfg: hashgrid.HashGridConfig, window: int,
                      level: int, device=None) -> float:
    """The share of corner gathers within each ``window``-sample tile that
    repeat an earlier gather of the same tile: the gather traffic a
    tile-local staging buffer saves."""
    tr = hash_address_trace(points, cfg, level, device)
    dup = total = 0
    for s in range(0, tr.shape[0], window):
        tile = tr[s:s + window].reshape(-1)
        total += tile.size
        dup += tile.size - np.unique(tile).size
    return dup / max(total, 1)


def gather_bytes(n_points: int, cfg: hashgrid.HashGridConfig,
                 dedup_rate: float = 0.0, bytes_per_feat: int = 4) -> float:
    """Embedding-gather bytes for ``n_points`` samples (all levels, 8
    corners), after a dedup rate: the paper's data-access currency."""
    per_point = cfg.n_levels * 8 * cfg.feature_dim * bytes_per_feat
    return n_points * per_point * (1.0 - dedup_rate)
