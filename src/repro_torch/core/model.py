"""Instant-NGP neural field assembly + the baseline (paper's "original")
renderer (``repro.core.model``).

A field's parameters are the reference's dict
``{"grid": (L, T, F), "mlps": {"density": [W...], "color": [W...]}}``
with each W a (fan_in, fan_out) float32 matrix.  ``init_ngp`` draws one;
``query_density`` / ``query_color`` / ``param_fns`` evaluate one, and
autograd flows to its tensors, which is how ``train.py`` trains.
``NGPField`` is an ``nn.Module`` that holds such a dict's tensors as
buffers, detached, for rendering: the kernels take it
(``kernels.ops.field_fns``) and have no backward.  ``paper_mlp=True``
sizes the color head so the density:color FLOP split matches the
paper's 8%:92%.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from .. import prng
from . import hashgrid, mlp, scene


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


def init_ngp(cfg: NGPConfig, key, device=None) -> Dict:
    """A params dict on ``device`` (the GPU unless ``device="cpu"``):
    tables uniform(-1e-4, 1e-4), Glorot-uniform weights; ``key`` (a
    ``prng`` key) split in two for the grid and the MLPs, as the
    reference's ``init_ngp`` splits it, so the draws are its own."""
    k_grid, k_mlps = prng.split(key)
    return {"grid": hashgrid.init_hashgrid(cfg.grid, k_grid, device),
            "mlps": mlp.init_mlps(cfg.net, k_mlps, device)}


def query_density(params: Dict, cfg: NGPConfig, points):
    """points (N,3) -> (sigma (N,), geo (N, G)) — zero outside the cube."""
    enc = hashgrid.encode(points, params["grid"], cfg.grid)
    sigma, geo = mlp.density_apply(params["mlps"], enc)
    inside = torch.all((points >= 0.0) & (points <= 1.0), dim=-1)
    return torch.where(inside, sigma, 0.0), geo


def query_color(params: Dict, cfg: NGPConfig, geo, dirs):
    return mlp.color_apply(params["mlps"], geo, dirs, cfg.net.sh_degree)


def query_field(params: Dict, cfg: NGPConfig, points, dirs):
    sigma, geo = query_density(params, cfg, points)
    return sigma, query_color(params, cfg, geo, dirs)


def param_fns(params: Dict, cfg: NGPConfig):
    """The plain-torch FieldFns of a params dict (the reference's
    ``field_fns(params, cfg)``)."""
    from .fields import FieldFns, replicable

    return replicable(
        FieldFns(density=lambda pts: query_density(params, cfg, pts),
                 color=lambda geo, dirs: query_color(params, cfg, geo, dirs)),
        lambda device: field_fns(NGPField.from_params(cfg, params)
                                 .replica(device)))


class NGPField(nn.Module):
    """Tables and weights of one NGP as buffers, for rendering: no
    gradients (``train.py`` trains a params dict and builds the field
    from it)."""

    def __init__(self, cfg: NGPConfig, grid: torch.Tensor,
                 density: list, color: list):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("grid", grid.detach().float().contiguous())
        self.n_density, self.n_color = len(density), len(color)
        for i, w in enumerate(density):
            self.register_buffer(f"density_{i}",
                                 w.detach().float().contiguous())
        for i, w in enumerate(color):
            self.register_buffer(f"color_{i}", w.detach().float().contiguous())

    @classmethod
    def from_params(cls, cfg: NGPConfig, params: Dict) -> "NGPField":
        """The field of a params dict, on its tensors' device, detached."""
        return cls(cfg, params["grid"], params["mlps"]["density"],
                   params["mlps"]["color"])

    @property
    def density_weights(self):
        return [getattr(self, f"density_{i}") for i in range(self.n_density)]

    @property
    def color_weights(self):
        return [getattr(self, f"color_{i}") for i in range(self.n_color)]

    def replica(self, device) -> "NGPField":
        """A copy of this field on ``device`` (``Module.to`` would move
        this one)."""
        def copy(t):
            return t.to(device, copy=True)

        return NGPField(self.cfg, copy(self.grid),
                        [copy(w) for w in self.density_weights],
                        [copy(w) for w in self.color_weights])

    def params(self) -> Dict:
        """The reference's params layout over this module's buffers."""
        return {"grid": self.grid,
                "mlps": {"density": self.density_weights,
                         "color": self.color_weights}}

    def query_density(self, points):
        """points (N,3) -> (sigma (N,), geo (N, G)) — zero outside the cube."""
        return query_density(self.params(), self.cfg, points)

    def query_color(self, geo, dirs):
        return query_color(self.params(), self.cfg, geo, dirs)


def field_fns(field: NGPField):
    """The plain-torch FieldFns of a field."""
    from .fields import FieldFns, replicable

    def density(points):
        return field.query_density(points)

    return replicable(FieldFns(density=density, color=field.query_color),
                      lambda device: field_fns(field.replica(device)))


def render_fixed(field: NGPField, origins, dirs, n_samples: int,
                 jitter=None, white_background: bool = True):
    """The paper's baseline: fixed ``n_samples`` per ray, full MLP per
    sample.  Returns (rgb (R,3), aux dict)."""
    from . import pipeline

    return pipeline.render_fixed_fns(field_fns(field), origins, dirs,
                                     n_samples, jitter,
                                     white_background=white_background)


def render_image(field: NGPField, cam, n_samples: int = 128,
                 chunk: int = 4096, device=None):
    """The fixed-``n_samples`` image of camera ``cam`` (H, W, 3), rendered
    on ``device`` (the GPU unless ``device="cpu"``; the field's) in a host
    loop over chunks of ``chunk`` rays."""
    o, d = scene.camera_rays(cam, device=device)
    rgb = torch.cat([render_fixed(field, o[s:s + chunk], d[s:s + chunk],
                                  n_samples)[0]
                     for s in range(0, o.shape[0], chunk)])
    return rgb.reshape(cam.height, cam.width, 3)
