"""Volume rendering (Eq. 1 of the paper) + early-termination accounting
(``repro.core.rendering``).

``C = sum_i T_i * alpha_i * c_i,  T_i = prod_{j<i} (1 - alpha_j),
  alpha_i = 1 - exp(-sigma_i * delta_i)``
"""
from __future__ import annotations

import torch

# Opacity saturation threshold for early termination (Instant-NGP's T < 1e-4).
EARLY_TERM_TRANSMITTANCE = 1e-4


def alphas_from_sigmas(sigmas, deltas):
    return 1.0 - torch.exp(-sigmas * deltas)


def transmittance(alphas):
    """Exclusive cumulative product of (1 - alpha) along the last axis."""
    one_minus = torch.clamp(1.0 - alphas, 1e-10, 1.0)
    log_t = torch.cumsum(torch.log(one_minus), dim=-1)
    log_t = torch.cat([torch.zeros_like(log_t[..., :1]), log_t[..., :-1]],
                      dim=-1)
    return torch.exp(log_t)


def composite(sigmas, colors, deltas, valid=None, white_background=True):
    """sigmas (..., S), colors (..., S, 3), deltas (..., S), valid optional
    bool (..., S) -> (rgb (..., 3), acc (...,), weights (..., S))."""
    if valid is not None:
        sigmas = torch.where(valid, sigmas, 0.0)
    alphas = alphas_from_sigmas(sigmas, deltas)
    weights = transmittance(alphas) * alphas
    rgb = torch.sum(weights[..., None] * colors, dim=-2)
    acc = torch.sum(weights, dim=-1)
    if white_background:
        rgb = rgb + (1.0 - acc[..., None])
    return rgb, acc, weights


def expected_termination_depth(weights, ts, acc, far: float):
    """Per-ray proxy termination depth ``E[t] + (1 - acc) * far``."""
    return torch.sum(weights * ts, dim=-1) + (1.0 - acc) * far


def psnr(img, ref):
    mse = torch.mean((img - ref) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
