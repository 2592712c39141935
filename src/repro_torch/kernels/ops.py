"""The kernel-backed field and the fused march at the shapes ``core/`` uses
(``repro.kernels.ops``).

  hash_encode(points, tables, cfg)         -> (N, L*F)
  density_mlp(enc, weights, cfg)           -> (sigma (N,), geo (N, G))
  color_mlp(geo, dirs, weights, cfg)       -> rgb (N, 3)
  fused_field(enc, dirs, res, cfg)         -> (sigma (N,), rgb (N, 3),
                                               geo (N, G))
  volume_render(sigmas, anchors, deltas, group) -> (rgb (R, 3), acc (R,))
  fused_march_blocks(res, acfg, o, d, bud) -> (rgb, acc, depth, chunks,
                                               ray_chunks)

``field_fns(field)`` returns a FieldFns whose density and color run the
CUDA kernels and which carries ``FusedMarchResources``, so
``ASDRConfig.march_backend="fused"`` sends Phase II to the fused march.
Weights stay at their true widths, row-major (fan_in, fan_out) fp32,
packed flat once per set of weight tensors (``packed_weights``, an LRU
shared by every engine in the process).
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from ..core import mlp as mlp_lib
from ..core import rendering, scene
from ..core.fields import FieldFns
from . import _build
from . import flash_attention as FA
from . import fused_march as FMA
from . import fused_mlp as FM
from . import hash_encode as HE
from . import volume_render as VR

TABLE_SUPPLIES = ("auto", "resident", "streamed")

# The march's scalars as float32 values, so the kernel (float arguments)
# and its plain version (python scalars against float32 tensors) use the
# same numbers.
NEAR32 = float(np.float32(scene.NEAR))
FAR32 = float(np.float32(scene.FAR))
LOG_EPS_T32 = float(np.float32(math.log(rendering.EARLY_TERM_TRANSMITTANCE)))


def hash_encode(points, tables, cfg):
    """points (N,3) -> encoding (N, L*F), matching hashgrid.encode."""
    meta = HE.grid_meta(cfg, points.device)
    return HE.hash_encode(points.float().contiguous(), meta, tables)


def density_mlp(enc, weights, cfg: mlp_lib.MLPConfig):
    """enc (N, D), weights = (flat, dims) of the density chain ->
    (sigma (N,), geo (N, G))."""
    out = FM.density_mlp(enc.float().contiguous(), *weights)
    return out[:, 0], out[:, 1:1 + cfg.geo_feature_dim]


def color_mlp(geo, dirs, weights, cfg: mlp_lib.MLPConfig):
    """(geo (N,G), dirs (N,3)), weights = (flat, dims) of the color chain
    -> rgb (N,3)."""
    cin = torch.cat([geo.float(), mlp_lib.sh_encode(dirs, cfg.sh_degree)],
                    dim=-1).contiguous()
    return FM.color_mlp(cin, *weights)


def fused_field(enc, dirs, res, cfg: mlp_lib.MLPConfig):
    """(enc (N, D), dirs (N, 3)) -> (sigma (N,), rgb (N, 3), geo (N, G)):
    both chains in one kernel.  ``res`` is a ``FusedMarchResources`` or
    the ((flat, dims) density, (flat, dims) color) pair of packed chains."""
    density, color = ((res.density, res.color)
                      if isinstance(res, FusedMarchResources) else res)
    sh = mlp_lib.sh_encode(dirs, cfg.sh_degree).float().contiguous()
    out = FM.fused_field(enc.float().contiguous(), sh, *density, *color)
    return out[:, 0], out[:, 1:4], out[:, 4:4 + cfg.geo_feature_dim]


def volume_render(sigmas, anchor_colors, deltas, group: int, valid=None,
                  white_background: bool = True):
    """Decoupled compositing: sigmas/deltas (R, S), anchor colors
    (R, A, 3) with A = ceil(S / group) -> (rgb (R, 3), acc (R,)).  A
    ``valid`` (R, S) mask zeroes sigma; the white background is added
    after the kernel."""
    sig = sigmas.float()
    if valid is not None:
        sig = torch.where(valid, sig, 0.0)
    out = VR.volume_render(sig.contiguous(), deltas.float().contiguous(),
                           anchor_colors.float().contiguous(), group)
    acc, rgb = out[:, 0], out[:, 1:4]
    if white_background:
        rgb = rgb + (1.0 - acc[:, None])
    return rgb, acc


# Packed weight chains are pure functions of the weight tensors, so they
# are memoized keyed on the tensors' identity: an engine restart or a
# second kernel field over the same weights re-uses the packed copies.
# Each entry keeps references to its source tensors, so their ids cannot
# be recycled while it lives; LRU-bounded at _PACK_MAX.
_PACK_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_PACK_LOCK = threading.Lock()
_PACK_MAX = 16
_PACK_STATS = {"hits": 0, "misses": 0}


def packed_weights(field):
    """Memoized ``(density, color)`` packed chains ((flat, dims) each) of
    an ``NGPField``'s MLP weights."""
    dw, cw = field.density_weights, field.color_weights
    key = (tuple(id(w) for w in dw), tuple(id(w) for w in cw))
    with _PACK_LOCK:
        hit = _PACK_CACHE.get(key)
        if hit is not None:
            _PACK_CACHE.move_to_end(key)
            _PACK_STATS["hits"] += 1
            return hit[0], hit[1]
        _PACK_STATS["misses"] += 1
    density, color = FM.pack_chain(dw), FM.pack_chain(cw)
    with _PACK_LOCK:
        _PACK_CACHE[key] = (density, color, list(dw), list(cw))
        _PACK_CACHE.move_to_end(key)
        while len(_PACK_CACHE) > _PACK_MAX:
            _PACK_CACHE.popitem(last=False)
    return density, color


def pack_cache_stats() -> Dict[str, int]:
    with _PACK_LOCK:
        return dict(_PACK_STATS, size=len(_PACK_CACHE))


class FusedMarchResources:
    """Device-resident inputs of the fused march: grid meta, tables and the
    two packed weight chains of one field."""

    def __init__(self, field):
        cfg = field.cfg
        self.meta = HE.grid_meta(cfg.grid, field.grid.device)
        self.tables = field.grid
        self.density, self.color = packed_weights(field)
        self.net = cfg.net


def fused_march_blocks(res: FusedMarchResources, acfg, o_b, d_b, budgets,
                       density_only: bool = False):
    """Run the single-kernel march over a batch of blocks.

    o_b/d_b (N, B, 3), budgets (N,) int32 -> (rgb (N,B,3), acc (N,B),
    depth (N,B), chunks (N,), ray_chunks (N,B)) with
    core.pipeline._march_block semantics.  SH features are computed once
    per ray here.  ``acfg.march_table_streaming`` is validated; on the GPU
    every value means the one table supply (device memory through L2).
    """
    if acfg.march_table_streaming not in TABLE_SUPPLIES:
        raise ValueError(f"march_table_streaming="
                         f"{acfg.march_table_streaming!r} not in "
                         f"{TABLE_SUPPLIES}")
    N, B, _ = o_b.shape
    o = o_b.float().reshape(N * B, 3).contiguous()
    d = d_b.float().reshape(N * B, 3).contiguous()
    sh = None if density_only else mlp_lib.sh_encode(d, res.net.sh_degree).contiguous()
    out = FMA.fused_march(
        o, d, sh, budgets.to(torch.int32).contiguous(), res.meta, res.tables,
        *res.density, *res.color, block_size=B, chunk=acfg.chunk,
        group=acfg.group, near=NEAR32, far=FAR32, log_eps_t=LOG_EPS_T32,
        early_term=acfg.early_termination,
        white_background=acfg.white_background, with_color=not density_only,
        per_ray_exit=acfg.per_ray_early_exit)
    out = out.reshape(N, B, FMA.OUT_W)
    return (out[:, :, 1:4], out[:, :, 0], out[:, :, 4],
            out[:, 0, 5].to(torch.int32), out[:, :, 6].to(torch.int32))


def field_fns(field) -> FieldFns:
    """Kernel-backed FieldFns of an ``NGPField``, carrying the fused-march
    resources."""
    cfg = field.cfg
    res = FusedMarchResources(field)

    def density(points):
        enc = hash_encode(points, field.grid, cfg.grid)
        sigma, geo = density_mlp(enc, res.density, cfg.net)
        inside = torch.all((points >= 0.0) & (points <= 1.0), dim=-1)
        return torch.where(inside, sigma, 0.0), geo

    def color(geo, dirs):
        return color_mlp(geo, dirs, res.color, cfg.net)

    return FieldFns(density=density, color=color, fused=res)


KERNELS = (HE.hash_encode, FM.density_mlp, FM.color_mlp, FMA.fused_march,
           FM.fused_field, VR.volume_render, FA.flash_attention)


def launch_counts() -> dict:
    with _build.launch_lock:
        return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    with _build.launch_lock:
        for k in KERNELS:
            k.launches = 0
