"""Depth-guided reprojection of per-pixel maps between nearby camera poses
(``repro.framecache.warp``).

A map computed per pixel at pose A (Phase-I sample counts, probe opacity,
or a finished radiance image) is forward-warped to a nearby pose B: every
source pixel is lifted to a world point with its proxy depth, projected
into B's image, and its value splatted at the landing pixel.

  * ``scatter_max`` — max over all source pixels landing on a target
    pixel, for count maps (over-sampling is safe, under-sampling is not);
  * ``nearest_source`` — the z-buffered winner (smallest destination
    distance, near-ties to the lowest source index, so the scatter is
    deterministic), for radiance, opacity and depth.

Target pixels no source lands on are disocclusions and come back with
``valid=False``.  Everything runs on the maps' device, one scatter and
gather per warp.

``project_to_camera`` rounds a float to a pixel index, so one ulp in the
camera-frame coordinates moves a splat or flips a near-tie: the products
are summed over k in order and the norm is not contracted, the reference's
float32 values at XLA's backend optimisation level 0 (as
``scene.camera_rays``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core import adaptive, scene
from ..obs import trace as trace_lib


def project_to_camera(points, cam) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Project world points (N, 3) into a camera's pixel grid.

    Returns (flat pixel index (N,) int64, ok (N,) bool, distance (N,)):
    ``ok`` is False for points behind the camera or landing outside the
    image; ``distance`` is the euclidean eye distance.
    """
    H, W = cam.height, cam.width
    dev = points.device
    origin = torch.from_numpy(np.asarray(cam.origin, np.float32)).to(dev)
    rot = torch.from_numpy(np.asarray(cam.c2w_rot, np.float32)).to(dev)
    p = points - origin
    a, b, c = p[:, :1], p[:, 1:2], p[:, 2:]
    # (points - origin) @ c2w_rot, each product rounded, summed over k
    rel = a * rot[0] + b * rot[1] + c * rot[2]
    z = rel[:, 2]
    in_front = z > 1e-6
    zs = torch.where(in_front, z, 1.0)
    # inverse of scene.camera_rays' pixel -> direction mapping
    i = torch.round(rel[:, 0] / zs * cam.focal + 0.5 * W - 0.5)
    j = torch.round(-rel[:, 1] / zs * cam.focal + 0.5 * H - 0.5)
    # the reference's float -> int32 conversion saturates
    i = torch.clamp(i, -2.0 ** 31, 2.0 ** 31 - 128).to(torch.int64)
    j = torch.clamp(j, -2.0 ** 31, 2.0 ** 31 - 128).to(torch.int64)
    ok = in_front & (i >= 0) & (i < W) & (j >= 0) & (j < H)
    # the norm in float64 so it rounds once when cast back
    dist = torch.sqrt((a * a + b * b + c * c).double()).float()[:, 0]
    return j * W + i, ok, dist


def forward_warp(cam_src, cam_dst, depth_src):
    """Reproject every source pixel into the destination image.

    depth_src: (H*W,) distance along each source ray.  Returns (target
    flat index, ok mask, distance in the destination frame), each (H*W,).
    """
    o, d = scene.camera_rays(cam_src, device=depth_src.device)
    pts = o + depth_src[:, None] * d
    return project_to_camera(pts, cam_dst)


def scatter_max(values, tgt_idx, ok, n_pixels: int, fill):
    """Max-splat ``values`` onto an ``n_pixels`` map.

    Returns (warped (n_pixels,), valid (n_pixels,) bool); pixels nothing
    landed on hold ``fill`` and valid=False.
    """
    idx = torch.where(ok, tgt_idx, n_pixels)        # off-image spill bin
    out = torch.full((n_pixels + 1,), fill, dtype=values.dtype,
                     device=values.device)
    out = out.scatter_reduce(0, idx, values, "amax", include_self=True)
    hit = torch.zeros((n_pixels + 1,), dtype=torch.int32, device=idx.device)
    hit = hit.index_add(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return out[:n_pixels], hit[:n_pixels] > 0


def nearest_source(tgt_idx, ok, dist, n_pixels: int):
    """Z-buffered winning source pixel per target pixel.

    Returns (src (n_pixels,) int64, clamped to 0 where invalid, and valid
    (n_pixels,) bool).  The winner has the smallest destination distance;
    among near-ties (relative 1e-5 plus 1e-6) the lowest source index wins.
    """
    N = tgt_idx.shape[0]
    dev = tgt_idx.device
    idx = torch.where(ok, tgt_idx, n_pixels)
    best = torch.full((n_pixels + 1,), float("inf"), device=dev)
    best = best.scatter_reduce(
        0, idx, torch.where(ok, dist, float("inf")), "amin", include_self=True)
    is_best = ok & (dist <= best[idx] * (1.0 + 1e-5) + 1e-6)
    cand = torch.where(is_best, idx, n_pixels)
    win = torch.full((n_pixels + 1,), N, dtype=torch.int64, device=dev)
    win = win.scatter_reduce(0, cand, torch.arange(N, device=dev), "amin",
                             include_self=True)[:n_pixels]
    valid = win < N
    return torch.where(valid, win, 0), valid


def warp_count_map(counts, depth, cam_src, cam_dst, ns_full: int,
                   margin: int = 1, projection=None):
    """Warp a Phase-I sample-count map from cam_src to cam_dst.

    Contributors reduce by max, disoccluded pixels get ``ns_full``, and a
    ``margin``-radius max-dilation absorbs the splat's rounding.  Returns
    (counts (H*W,) int32, valid mask).  ``projection``: a precomputed
    ``forward_warp(cam_src, cam_dst, depth)`` result.
    """
    H, W = cam_dst.height, cam_dst.width
    with trace_lib.span("warp.count_map", pixels=H * W):
        tgt, ok, _ = (projection if projection is not None
                      else forward_warp(cam_src, cam_dst, depth))
        warped, valid = scatter_max(counts, tgt, ok, H * W, fill=0)
        warped = torch.where(valid, warped, ns_full).to(counts.dtype)
        if margin > 0:
            warped = adaptive.dilate_count_map(warped, (H, W), margin,
                                               border_fill=ns_full)
        return warped, valid


def warp_image(rgb, acc, depth, cam_src, cam_dst, background: float = 1.0):
    """Warp a finished radiance frame (rgb (H*W,3), acc, depth) to cam_dst.

    Z-buffered nearest-surface warp; disoccluded pixels come back as
    ``background`` rgb / zero acc / FAR depth with valid=False.  Returns
    (rgb, acc, depth, valid), all in the destination frame.
    """
    H, W = cam_dst.height, cam_dst.width
    with trace_lib.span("warp.image", pixels=H * W):
        tgt, ok, dist = forward_warp(cam_src, cam_dst, depth)
        src, valid = nearest_source(tgt, ok, dist, H * W)
        rgb_w = torch.where(valid[:, None], rgb[src], background)
        acc_w = torch.where(valid, acc[src], 0.0)
        depth_w = torch.where(valid, dist[src], scene.FAR)
        return rgb_w, acc_w, depth_w, valid
