"""The plain reference of the Instant-NGP field: hash-grid encoding, the
density and colour MLPs and the spherical-harmonics direction encoding,
in float32 PyTorch operations.

It reads a configuration file's ``grid`` and ``mlp`` groups and a params
dict ``{"grid": (L, T, F), "density": [W...], "color": [W...]}`` with each
W a (fan_in, fan_out) matrix.  It follows Instant-NGP's equations as the
repository's JAX package states them (dense low levels indexed row-major,
the spatial hash of Eq. 2 above them, trilinear blending of the 8
corners, ``trunc_exp`` density, sigmoid colour) and imports nothing of
the program.
"""
from __future__ import annotations

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
CORNERS = tuple(((c >> 2) & 1, (c >> 1) & 1, c & 1) for c in range(8))


def level_resolutions(grid: dict) -> list:
    L = grid["n_levels"]
    growth = 1.0 if L == 1 else float(np.exp(
        (np.log(grid["max_resolution"]) - np.log(grid["base_resolution"]))
        / (L - 1)))
    return [int(np.floor(grid["base_resolution"] * growth ** l))
            for l in range(L)]


def encode(points: torch.Tensor, tables: torch.Tensor, grid: dict):
    """points (N, 3) in [0, 1]^3 -> (N, L * F)."""
    T = tables.shape[1]
    corners = torch.tensor(CORNERS, device=points.device)
    out = []
    for l, res in enumerate(level_resolutions(grid)):
        scaled = points * float(res)
        base = torch.clamp(torch.floor(scaled).to(torch.int64), 0, res - 1)
        frac = scaled - base.to(points.dtype)
        c = base[:, None, :] + corners[None]                    # (N, 8, 3)
        if (res + 1) ** 3 <= T:
            s = res + 1
            idx = c[..., 0] + s * (c[..., 1] + s * c[..., 2])
        else:
            h = (c[..., 0] * PRIMES[0]) & _U32
            h = h ^ ((c[..., 1] * PRIMES[1]) & _U32)
            h = h ^ ((c[..., 2] * PRIMES[2]) & _U32)
            idx = h % T
        feats = tables[l][idx]                                  # (N, 8, F)
        w = torch.where(corners[None].bool(), frac[:, None, :],
                        1.0 - frac[:, None, :])
        w = w[..., 0] * w[..., 1] * w[..., 2]                   # (N, 8)
        acc = torch.zeros_like(feats[:, 0])
        for k in range(8):
            acc = acc + feats[:, k] * w[:, k, None]
        out.append(acc)
    return torch.cat(out, dim=-1)


def mlp(ws, x):
    for i, w in enumerate(ws):
        x = x @ w
        if i < len(ws) - 1:
            x = torch.relu(x)
    return x


def sh_encode(d):
    """Real spherical harmonics of degree 4 (16 components); d unit (N, 3)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz, 0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy)], dim=-1)


class Field:
    """density(points) -> (sigma (N,), geo (N, G)); color(geo, dirs) ->
    rgb (N, 3).  Sigma is zero outside the unit cube."""

    def __init__(self, params: dict, cfg: dict):
        self.params, self.grid = params, cfg["grid"]
        if cfg["mlp"]["sh_degree"] != 4:
            raise ValueError("the reference encodes directions at degree 4")

    def density(self, points):
        out = mlp(self.params["density"],
                  encode(points, self.params["grid"], self.grid))
        sigma = torch.exp(torch.clamp(out[:, 0], -15.0, 15.0))
        inside = torch.all((points >= 0.0) & (points <= 1.0), dim=-1)
        return torch.where(inside, sigma, 0.0), out[:, 1:]

    def color(self, geo, dirs):
        x = torch.cat([geo, sh_encode(dirs)], dim=-1)
        return torch.sigmoid(mlp(self.params["color"], x))


def mlp_sizes(cfg: dict):
    """(density widths, color widths) of a configuration's ``mlp`` group."""
    m = cfg["mlp"]
    enc = cfg["grid"]["n_levels"] * cfg["grid"]["feature_dim"]
    density = ([enc] + [m["density_hidden"]] * m["density_layers"]
               + [1 + m["geo_feature_dim"]])
    color = ([m["geo_feature_dim"] + m["sh_degree"] ** 2]
             + [m["color_hidden"]] * m["color_layers"] + [3])
    return density, color


def table_rows(cfg: dict) -> int:
    return 1 << cfg["grid"]["log2_table_size"]

