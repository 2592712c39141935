"""§4.2 — Adaptive sampling with rendering-difficulty awareness
(``repro.core.adaptive``).

Phase I renders every d-th pixel at the full count ``ns``, re-composites
the same (sigma, color) samples at reduced counts ``ns_i`` by stride
subsampling, picks the smallest ``ns_i`` whose difficulty ``rd_i`` (Eq. 3)
is ``<= delta`` and interpolates the counts bilinearly to every pixel.
Phase II sorts rays by count into homogeneous blocks (stable sort, as the
reference's ``argsort``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import rendering, scene

# Default candidate ladder (spans the same 16x range as the paper's 12..192).
DEFAULT_CANDIDATES = (12, 24, 48, 96)


def subsampled_composite(sigmas, colors, ns_full: int, ns_i: int,
                         white_background: bool = True):
    """Re-composite using every (ns_full//ns_i)-th of the existing samples.

    sigmas (R, S), colors (R, S, 3) from the full-count probe render.
    """
    stride = ns_full // ns_i
    sub_s = sigmas[:, ::stride][:, :ns_i]
    sub_c = colors[:, ::stride][:, :ns_i]
    deltas = torch.full(sub_s.shape, (scene.FAR - scene.NEAR) / ns_i,
                        device=sigmas.device)
    rgb, _, _ = rendering.composite(sub_s, sub_c, deltas,
                                    white_background=white_background)
    return rgb


def rendering_difficulty(rgb_full, rgb_sub):
    """Eq. (3): rd_i = max(|dr|, |dg|, |db|) per ray. Colors in [0,1]."""
    return torch.max(torch.abs(rgb_full - rgb_sub), dim=-1).values


def probe_counts(sigmas, colors, rgb_full, ns_full: int,
                 candidates: Sequence[int] = DEFAULT_CANDIDATES,
                 delta: float = 1.0 / 2048.0):
    """Per-probe-ray sample counts: smallest ns_i with rd_i <= delta.

    Returns int32 (R,) counts drawn from candidates + [ns_full].
    """
    counts = torch.full((rgb_full.shape[0],), ns_full, dtype=torch.int32,
                        device=rgb_full.device)
    # iterate descending so the smallest passing candidate wins
    for ns_i in sorted(candidates, reverse=True):
        rgb_i = subsampled_composite(sigmas, colors, ns_full, ns_i)
        rd = rendering_difficulty(rgb_full, rgb_i)
        counts = torch.where(rd <= delta, ns_i, counts).to(torch.int32)
    return counts


def interpolate_map(probe, probe_hw: Tuple[int, int],
                    full_hw: Tuple[int, int]):
    """Float bilinear interpolation of a per-probe-pixel map to full res.

    probe: (ph*pw,) values on the strided probe grid.  Returns float32
    (H*W,), equal bit for bit to the reference's (same ``linspace``, same
    order of operations), because ``interpolate_counts`` rounds it up.
    """
    ph, pw = probe_hw
    H, W = full_hw
    dev = probe.device
    grid = probe.reshape(ph, pw).to(torch.float32)
    ys = scene.linspace(0.0, ph - 1.0, H, device=dev)
    xs = scene.linspace(0.0, pw - 1.0, W, device=dev)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, ph - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, pw - 1)
    y1 = torch.clamp(y0 + 1, 0, ph - 1)
    x1 = torch.clamp(x0 + 1, 0, pw - 1)
    wy = (ys - y0.to(torch.float32))[:, None]
    wx = (xs - x0.to(torch.float32))[None, :]
    v = (
        grid[y0][:, x0] * (1 - wy) * (1 - wx)
        + grid[y0][:, x1] * (1 - wy) * wx
        + grid[y1][:, x0] * wy * (1 - wx)
        + grid[y1][:, x1] * wy * wx
    )
    return v.reshape(H * W)


def interpolate_counts(probe, probe_hw: Tuple[int, int],
                       full_hw: Tuple[int, int],
                       candidates: Sequence[int] = DEFAULT_CANDIDATES,
                       ns_full: int = 192):
    """Bilinear interpolation of the probe-count map to the full image, then
    conservative snap-UP to the candidate ladder (paper §4.2)."""
    v = interpolate_map(probe, probe_hw, full_hw)
    ladder = torch.tensor(sorted(set(list(candidates) + [ns_full])),
                          dtype=torch.int32, device=probe.device)
    idx = torch.searchsorted(ladder, torch.ceil(v).to(torch.int32),
                             side="left")
    idx = torch.clamp(idx, 0, ladder.shape[0] - 1)
    return ladder[idx]


def sort_rays_into_blocks(counts, block_size: int):
    """Stable sort of ray indices by sample count -> (order (R,) int32,
    per-block budget (R // block_size,) int32 = max count in the block).
    R must be divisible by block_size (pad rays upstream)."""
    order = torch.argsort(counts, stable=True)
    budgets = counts[order].reshape(-1, block_size).max(dim=1).values
    return order.to(torch.int32), budgets


def compute_savings(counts, ns_full: int) -> dict:
    """Analytic work-reduction stats (paper: avg 120 vs 192 on Lego)."""
    avg = float(torch.mean(counts.to(torch.float32)))
    return {
        "avg_samples_per_ray": avg,
        "sample_reduction": ns_full / max(avg, 1e-9),
        "fraction_background": float(torch.mean(
            (counts <= min(DEFAULT_CANDIDATES)).to(torch.float32))),
    }
