"""Instant-NGP's density and color MLPs + spherical-harmonics direction
encoding (``repro.core.mlp``).

Weights are row-major (fan_in, fan_out) float32 matrices with no biases;
the density network's output column 0 is the sigma logit and columns 1..G
the geometry feature, the color network reads [geo, SH(dir)].
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .. import prng
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    encoding_dim: int = 32          # n_levels * feature_dim
    density_hidden: int = 64
    density_layers: int = 1         # hidden layers
    geo_feature_dim: int = 15
    sh_degree: int = 4              # 16 SH components
    color_hidden: int = 64
    color_layers: int = 2           # hidden layers

    @property
    def sh_dim(self) -> int:
        return self.sh_degree**2

    @property
    def color_input_dim(self) -> int:
        return self.geo_feature_dim + self.sh_dim

    def density_sizes(self) -> List[int]:
        return ([self.encoding_dim] + [self.density_hidden] * self.density_layers
                + [1 + self.geo_feature_dim])

    def color_sizes(self) -> List[int]:
        return ([self.color_input_dim] + [self.color_hidden] * self.color_layers
                + [3])


def flops_per_sample(cfg: MLPConfig) -> Dict[str, float]:
    """2*fan_in*fan_out per matmul row, for each chain, and the color
    chain's share (the paper's 8 %:92 % split)."""
    def chain(sizes):
        return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))
    d, c = chain(cfg.density_sizes()), chain(cfg.color_sizes())
    return {"density_flops": float(d), "color_flops": float(c),
            "color_fraction": c / (c + d)}


def _dense_init(key, fan_in: int, fan_out: int, device) -> torch.Tensor:
    """Glorot-uniform (fan_in, fan_out) float32 weights: the reference's
    float32 scale sqrt(6 / (fan_in + fan_out)) and its uniform draw."""
    scale = float(np.sqrt(np.float32(6.0 / (fan_in + fan_out))))
    return prng.uniform(key, (fan_in, fan_out), minval=-scale, maxval=scale,
                        device=device)


def init_mlps(cfg: MLPConfig, key, device=None) -> Dict:
    """{"density": [W...], "color": [W...]}, Glorot-uniform, on ``device``
    (the GPU unless ``device="cpu"``): ``key`` split in 8 as the reference
    splits it, the density chain's layers from keys 0-3 and the color
    chain's from keys 4-7."""
    dev = resolve_device(device)
    keys = prng.split(key, 8)

    def chain(sizes, first):
        return [_dense_init(keys[first + i], a, b, dev)
                for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))]

    return {"density": chain(cfg.density_sizes(), 0),
            "color": chain(cfg.color_sizes(), 4)}


def _mlp_forward(ws, x, final_act=None):
    for i, w in enumerate(ws):
        x = x @ w
        if i < len(ws) - 1:
            x = torch.relu(x)
    return final_act(x) if final_act is not None else x


def trunc_exp(x):
    """Numerically-safe exp used by Instant-NGP for density activation."""
    return torch.exp(torch.clamp(x, -15.0, 15.0))


def density_apply(params: Dict, encoding):
    """(N, encoding_dim) -> (sigma (N,), geo_feat (N, geo_feature_dim))."""
    out = _mlp_forward(params["density"], encoding)
    return trunc_exp(out[..., 0]), out[..., 1:]


def sh_encode(dirs, degree: int = 4):
    """Real spherical harmonics up to ``degree`` (degree<=4 -> 16 dims);
    dirs (N, 3) unit vectors."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    comps = [torch.full_like(x, 0.28209479177387814)]
    if degree > 1:
        comps += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree > 2:
        comps += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
        ]
    if degree > 3:
        comps += [
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ]
    return torch.stack(comps, dim=-1)


def color_apply(params: Dict, geo_feat, dirs, sh_degree: int = 4):
    """(N, geo) x (N, 3) -> rgb (N, 3) in [0, 1]."""
    x = torch.cat([geo_feat, sh_encode(dirs, sh_degree)], dim=-1)
    return _mlp_forward(params["color"], x, final_act=torch.sigmoid)
