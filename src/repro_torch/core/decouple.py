"""§4.3 — Color-density decoupling via color-wise locality
(``repro.core.decouple``).

Every sample gets a density-MLP evaluation; only every ``n``-th sample
(the group anchor) gets a color-MLP evaluation.  Non-anchor colors are
linear interpolations between the two enclosing anchors; the trailing
group clamps to the last anchor.
"""
from __future__ import annotations

import torch

from . import rendering, scene
from .fields import FieldFns


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


def render_decoupled(fns: FieldFns, origins, dirs, n_samples: int,
                     group: int = 2, jitter=None,
                     white_background: bool = True,
                     keep_samples: bool = False):
    """Decoupled renderer: density for all samples, color for anchors only.

    ``jitter``: optional (R, n_samples) uniform [0, 1) draws
    (scene.sample_points).  Returns (rgb, stats) where stats counts the
    MLP evaluations; with ``keep_samples`` it also holds the ``sigmas``
    (R, S), ``anchor_colors`` (R, A, 3) and ``deltas`` (R, S) that were
    composited.
    """
    pts, deltas, _ = scene.sample_points(origins, dirs, n_samples, jitter)
    R, S = pts.shape[:2]
    sigma, geo = fns.density(pts.reshape(-1, 3))
    sigma = sigma.reshape(R, S)
    geo = geo.reshape(R, S, -1)

    anchor_idx = torch.arange(0, S, group, device=pts.device)
    A = anchor_idx.shape[0]
    geo_anchor = geo[:, anchor_idx].reshape(R * A, -1)
    dirs_anchor = torch.repeat_interleave(dirs, A, dim=0)
    anchor_colors = fns.color(geo_anchor, dirs_anchor).reshape(R, A, 3)

    colors = interpolate_group_colors(anchor_colors, group, S)
    rgb, _, _ = rendering.composite(sigma, colors, deltas,
                                    white_background=white_background)
    stats = {"density_evals": R * S, "color_evals": R * A,
             "color_eval_fraction": A / S}
    if keep_samples:
        stats.update(sigmas=sigma, anchor_colors=anchor_colors, deltas=deltas)
    return rgb, stats


def render_naive_reduced(fns: FieldFns, origins, dirs, n_samples: int,
                         factor: int = 2, jitter=None):
    """The paper's Fig. 9(b) strawman: ``n_samples // factor`` samples,
    density AND color MLP on each.  ``jitter`` is (R, n_samples // factor)."""
    from . import pipeline

    rgb, _ = pipeline.render_fixed_fns(fns, origins, dirs,
                                       n_samples // factor, jitter)
    return rgb


def mlp_flops_saved(cfg, n_samples: int, group: int) -> dict:
    """Analytic MLP-FLOP reduction from decoupling (paper: 46% at n=2 with
    the 92%-color-share MLP)."""
    from . import mlp as mlp_lib

    f = mlp_lib.flops_per_sample(cfg.net)
    full = n_samples * (f["density_flops"] + f["color_flops"])
    anchors = -(-n_samples // group)
    dec = n_samples * f["density_flops"] + anchors * f["color_flops"]
    return {"full_mlp_flops": full, "decoupled_mlp_flops": dec,
            "reduction_fraction": 1.0 - dec / full}
