"""Instant-NGP neural field assembly + the baseline (paper's "original")
renderer (``repro.core.model``).

``NGPField`` is an ``nn.Module`` that holds the hash tables and MLP
weights as buffers, in the reference layout: tables (L, T, F), weights
(fan_in, fan_out).  ``paper_mlp=True`` sizes the color head so the
density:color FLOP split matches the paper's 8%:92%.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from . import hashgrid, mlp


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    grid: hashgrid.HashGridConfig = hashgrid.HashGridConfig()
    net: mlp.MLPConfig = mlp.MLPConfig()

    @staticmethod
    def make(
        n_levels=16, log2_table_size=19, feature_dim=2,
        base_resolution=16, max_resolution=2048, paper_mlp=False,
    ) -> "NGPConfig":
        grid = hashgrid.HashGridConfig(
            n_levels=n_levels, log2_table_size=log2_table_size,
            feature_dim=feature_dim, base_resolution=base_resolution,
            max_resolution=max_resolution,
        )
        if paper_mlp:
            net = mlp.MLPConfig(encoding_dim=grid.output_dim,
                                color_hidden=128, color_layers=3)
        else:
            net = mlp.MLPConfig(encoding_dim=grid.output_dim)
        return NGPConfig(grid=grid, net=net)

    @staticmethod
    def small(paper_mlp=False) -> "NGPConfig":
        """The CPU-sized config the tests and examples use."""
        return NGPConfig.make(n_levels=8, log2_table_size=14,
                              max_resolution=256, paper_mlp=paper_mlp)


class NGPField(nn.Module):
    """Tables and weights of one NGP as buffers (no gradients: the port's
    first slice renders, it does not train)."""

    def __init__(self, cfg: NGPConfig, grid: torch.Tensor,
                 density: list, color: list):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("grid", grid.float().contiguous())
        self.n_density, self.n_color = len(density), len(color)
        for i, w in enumerate(density):
            self.register_buffer(f"density_{i}", w.float().contiguous())
        for i, w in enumerate(color):
            self.register_buffer(f"color_{i}", w.float().contiguous())

    @property
    def density_weights(self):
        return [getattr(self, f"density_{i}") for i in range(self.n_density)]

    @property
    def color_weights(self):
        return [getattr(self, f"color_{i}") for i in range(self.n_color)]

    def params(self) -> Dict:
        """The reference's params pytree layout over this module's buffers."""
        return {"grid": self.grid,
                "mlps": {"density": self.density_weights,
                         "color": self.color_weights}}

    def query_density(self, points):
        """points (N,3) -> (sigma (N,), geo (N, G)) — zero outside the cube."""
        enc = hashgrid.encode(points, self.grid, self.cfg.grid)
        sigma, geo = mlp.density_apply(self.params()["mlps"], enc)
        inside = torch.all((points >= 0.0) & (points <= 1.0), dim=-1)
        return torch.where(inside, sigma, 0.0), geo

    def query_color(self, geo, dirs):
        return mlp.color_apply(self.params()["mlps"], geo, dirs,
                               self.cfg.net.sh_degree)


def field_fns(field: NGPField):
    """The plain-torch FieldFns of a field."""
    from .fields import FieldFns

    return FieldFns(density=field.query_density, color=field.query_color)


def render_fixed(field: NGPField, origins, dirs, n_samples: int,
                 jitter=None, white_background: bool = True):
    """The paper's baseline: fixed ``n_samples`` per ray, full MLP per
    sample.  Returns (rgb (R,3), aux dict)."""
    from . import pipeline

    return pipeline.render_fixed_fns(field_fns(field), origins, dirs,
                                     n_samples, jitter,
                                     white_background=white_background)
