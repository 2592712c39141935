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


def early_termination_counts(alphas):
    """Number of samples each ray needs before T drops below the
    early-termination threshold (the ideal per-ray count of §6.6)."""
    trans = transmittance(alphas)
    return torch.sum(trans >= EARLY_TERM_TRANSMITTANCE, dim=-1)


def psnr(img, ref):
    mse = torch.mean((img - ref) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def ssim(img, ref, window: int = 8):
    """Simplified SSIM over non-overlapping windows; img/ref (H, W, 3) in
    [0, 1]."""
    H, W, C = img.shape
    h, w = H // window * window, W // window * window

    def blocks(x):
        x = x[:h, :w].reshape(h // window, window, w // window, window, C)
        return x.permute(0, 2, 1, 3, 4).reshape(-1, window * window, C)

    a, b = blocks(img), blocks(ref)
    mu_a, mu_b = a.mean(dim=1), b.mean(dim=1)
    var_a, var_b = a.var(dim=1, correction=0), b.var(dim=1, correction=0)
    cov = ((a - mu_a[:, None]) * (b - mu_b[:, None])).mean(dim=1)
    c1, c2 = 0.01**2, 0.03**2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return s.mean()
