"""§4.3 — Color-density decoupling via color-wise locality
(``repro.core.decouple``)."""
from __future__ import annotations

import torch


def interpolate_group_colors(anchor_colors, n: int, S: int):
    """Expand anchor colors (R, A, 3) to all samples (R, S, 3) by lerp.

    Anchors sit at sample indices 0, n, 2n, ...  Sample j lies in group
    i = j // n with offset t = (j % n) / n and is lerp(anchor_i,
    anchor_{i+1}, t), the anchor index clamped at the end.
    """
    R, A, _ = anchor_colors.shape
    j = torch.arange(S, device=anchor_colors.device)
    gi = j // n
    t = (j % n).to(anchor_colors.dtype) / torch.full(
        (S,), float(n), device=anchor_colors.device)
    left = anchor_colors[:, torch.clamp(gi, 0, A - 1)]
    right = anchor_colors[:, torch.clamp(gi + 1, 0, A - 1)]
    return left + (right - left) * t[None, :, None]
