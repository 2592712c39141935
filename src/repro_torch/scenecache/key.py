"""Scene-space block keys: quantized voxel footprint + view bucket
(``repro.scenecache.key``; byte-identical digests for equal inputs).

A Phase-II block is a set of ``block_size`` rays marched together under
one sample budget.  Its output (rgb/acc/depth contributions per ray)
depends only on the rays' geometry, the budget, and the render config —
not on which request, user, or frame the block came from.  That makes
block outputs cacheable in *scene space*: the key is what the block
looks at, not whose frame it belongs to.

The key quantizes each ray to

  * its **voxel footprint** — the scene voxels at the near- and far-plane
    ends of the ray's chord (two ``voxel_res``-resolution cells fix the
    line up to quantization), and
  * its **view bucket** — the ray direction quantized to a
    ``view_buckets``-per-axis lattice on the direction cube (radiance is
    view-dependent: two chords through the same voxels in opposite
    directions must not collide),

then hashes the whole block's quantized arrays together with the budget,
the scene id, and the render config.  Two blocks whose rays land in the
same cells — the same pose re-requested by another user, or a pose close
enough that no ray crosses a cell boundary — get the same key and share
one march.

Alongside the exact key, each block gets a coarse **coverage cell** (the
``coverage_res``-resolution voxel of its mid-chord centroid plus a coarse
direction bucket).  The store's eviction policy uses it: entries whose
cell is covered by other resident entries are redundant and evict first
(store.py).

Host-side numpy only — keys are computed once per block per request.
``acfg_token`` is the config's repr: the port's ``ASDRConfig`` has the
reference's fields in the reference's order, so equal configs give
equal keys in both packages.
"""
from __future__ import annotations

import hashlib
import struct
from typing import List, Tuple

import numpy as np
import torch

from ..core import scene

# bump when the key layout changes: stale digests must never alias
_KEY_VERSION = 1
_CELL_VIEW_BUCKETS = 8


def acfg_token(acfg) -> bytes:
    """Stable byte token for a render config.

    ASDRConfig is a frozen dataclass of numbers/tuples/bools, so its repr
    is deterministic across processes (unlike ``hash()`` on strings).
    """
    return repr(acfg).encode()


def host_array(x) -> np.ndarray:
    """A tensor's host copy as numpy (numpy and lists as they are)."""
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def block_keys(cfg, scene_id: str, acfg, origins: np.ndarray,
               dirs: np.ndarray, budgets: np.ndarray
               ) -> List[Tuple[bytes, tuple]]:
    """(key digest, coverage cell) for every block in a stack.

    origins/dirs: (N, B, 3) float arrays (host or device — converted
    once); budgets: (N,) ints.  Returns N pairs, index-aligned.
    """
    o = host_array(origins).astype(np.float32, copy=False)
    d = host_array(dirs).astype(np.float32, copy=False)
    buds = host_array(budgets)
    p0 = o + np.float32(scene.NEAR) * d
    p1 = o + np.float32(scene.FAR) * d
    v0 = np.floor(p0 * cfg.voxel_res).astype(np.int32)
    v1 = np.floor(p1 * cfg.voxel_res).astype(np.int32)
    vb = np.floor((d * 0.5 + 0.5) * cfg.view_buckets).astype(np.int32)
    np.clip(vb, -1, cfg.view_buckets, out=vb)

    prefix = hashlib.blake2b(
        acfg_token(acfg) + b"\x00" + scene_id.encode()
        + struct.pack("<iiii", _KEY_VERSION, cfg.voxel_res,
                      cfg.view_buckets, o.shape[1]),
        digest_size=16).digest()

    mid = 0.5 * (p0 + p1).mean(axis=1)                       # (N, 3)
    cell_v = np.floor(mid * cfg.coverage_res).astype(np.int64)
    cell_d = np.floor((d.mean(axis=1) * 0.5 + 0.5)
                      * _CELL_VIEW_BUCKETS).astype(np.int64)

    out = []
    for i in range(o.shape[0]):
        h = hashlib.blake2b(prefix, digest_size=16)
        h.update(v0[i].tobytes())
        h.update(v1[i].tobytes())
        h.update(vb[i].tobytes())
        h.update(struct.pack("<q", int(buds[i])))
        cell = (scene_id, *cell_v[i].tolist(), *cell_d[i].tolist())
        out.append((h.digest(), cell))
    return out
