"""Field abstraction — the composability seam of the renderer
(``repro.core.fields``).

``density(points) -> (sigma (N,), geo (N, G))`` and
``color(geo, dirs) -> rgb (N, 3)``.  The same pipeline runs the NGP
network in plain torch (``model.field_fns``), the analytic scenes
(``analytic_field_fns``) and the CUDA-kernel-backed network
(``kernels.ops.field_fns``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class FieldFns(NamedTuple):
    density: Callable  # (N,3) -> (sigma (N,), geo (N,G))
    color: Callable    # (geo (N,G), dirs (N,3)) -> rgb (N,3)
    # Optional fused-march resources (kernels.ops.FusedMarchResources).
    # When present AND ASDRConfig.march_backend == "fused", Phase II runs
    # the single-kernel march (kernels/fused_march.py); None everywhere
    # else, and those fields keep the chunked reference march.
    fused: object = None


def analytic_field_fns(field) -> FieldFns:
    """Wrap an analytic ``scene.Field`` (points -> (sigma, color))."""

    def density(points):
        sigma, color = field(points)
        inside = torch.all((points >= 0.0) & (points <= 1.0), dim=-1)
        return torch.where(inside, sigma, 0.0), color

    def color(geo, dirs):
        del dirs
        return geo

    return FieldFns(density=density, color=color)
