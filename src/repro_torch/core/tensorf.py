"""TensoRF's VM-decomposed radiance field (Chen et al., "TensoRF:
Tensorial Radiance Fields", ECCV 2022, arXiv:2203.09517), the second
field family the ASDR frame renders beside Instant-NGP.

``TensorVMSplit`` with ``shadingMode MLP_Fea`` as the official code
writes it (``models/tensoRF.py``, ``models/tensorBase.py``):

- density: three plane / line pairs, planes on the axis pairs
  ``MAT_MODE`` and lines on the axes ``VEC_MODE``, read by bilinear and
  linear ``grid_sample`` (``align_corners=True``, zero padding) at the
  point's coordinates normalized to [-1, 1]; the feature is the sum over
  pairs and components of plane x line, and sigma is ``softplus(feature
  + density_shift)``;
- appearance: the same read of three larger plane / line pairs, the
  products of all components through the bias-free ``basis_mat``
  (``app_dim`` outputs), then ``MLPRender_Fea``: [features, viewdirs,
  PE(features, fea_pe), PE(viewdirs, view_pe)] -> hidden -> hidden -> 3,
  with biases, ReLU between layers and a sigmoid at the end.

The renderer's unit cube stands for TensoRF's aabb (lego's [-1.5, 1.5]^3,
``aabb_size`` 3 world units a side), and a step of the ASDR march is in
unit-cube lengths, so the sigma this field returns is TensoRF's times
``distance_scale`` times ``aabb_size`` (25 x 3 = 75): alpha = 1 -
exp(-sigma * delta) is then TensoRF's alpha for the same segment.  Sigma
is zero outside the cube, where TensoRF masks samples by the aabb.

Params are TensoRF's own layout: planes (1, C, H, W) with W the first
axis of the pair, lines (1, C, H, 1), the basis (app_dim, sum of the
appearance components) and the MLP's (out, in) weights with their
biases, as ``nn.Linear`` holds them.  ``field_fns`` evaluates them with
library operations (``grid_sample``, ``F.linear``) in chunks of points,
so its density's ``geo`` is the point itself and the appearance runs
where ``color`` runs: on the §4.3 anchors only.  ``kernels.ops.
tensorf_field_fns`` adds the resources of the fused VM march.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import prng
from ..device import resolve_device
from ..obs import trace as trace_lib

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)
# points a library call of the field takes at once: the appearance path
# holds ~900 floats a point, so a chunk stays under ~4 GB
POINTS_PER_CALL = 1 << 20


@dataclasses.dataclass(frozen=True)
class TensoRFConfig:
    """The published settings of TensoRF's ``configs/lego.txt`` (VM-192)."""
    resolution: Tuple[int, int, int] = (300, 300, 300)   # N_voxel_final 300^3
    density_components: Tuple[int, int, int] = (16, 16, 16)   # n_lamb_sigma
    app_components: Tuple[int, int, int] = (48, 48, 48)      # n_lamb_sh
    app_dim: int = 27                  # data_dim_color
    fea_pe: int = 2
    view_pe: int = 2
    hidden: int = 128                  # featureC
    density_shift: float = -10.0
    distance_scale: float = 25.0
    aabb_size: float = 3.0             # world units of the unit cube's side

    @property
    def sigma_scale(self) -> float:
        return self.distance_scale * self.aabb_size

    @property
    def mlp_in(self) -> int:
        return (self.app_dim + 3 + 2 * self.fea_pe * self.app_dim
                + 2 * self.view_pe * 3)

    def plane_shape(self, i: int, c: int) -> Tuple[int, int, int, int]:
        a, b = MAT_MODE[i]
        return (1, c, self.resolution[b], self.resolution[a])

    def line_shape(self, i: int, c: int) -> Tuple[int, int, int, int]:
        return (1, c, self.resolution[VEC_MODE[i]], 1)

    def mlp_sizes(self):
        return [self.mlp_in, self.hidden, self.hidden, 3]


def init_tensorf(cfg: TensoRFConfig, key, device=None) -> Dict:
    """A params dict on ``device``: TensoRF's ``0.1 * randn`` planes and
    lines, and ``nn.Linear``'s init for the basis and the MLP (weights and
    biases uniform in +-1/sqrt(fan_in), the last bias 0), drawn through
    ``prng`` from ``key`` split in 16."""
    dev = resolve_device(device)
    keys = prng.split(key, 16)

    def randn(k, shape):
        return prng.normal(keys[k], shape, device=dev) * 0.1

    def linear(k, fan_in, fan_out):
        bound = 1.0 / math.sqrt(fan_in)
        return prng.uniform(keys[k], (fan_out, fan_in), minval=-bound,
                            maxval=bound, device=dev)

    params = {
        "density_plane": [randn(i, cfg.plane_shape(i, c))
                          for i, c in enumerate(cfg.density_components)],
        "density_line": [randn(3 + i, cfg.line_shape(i, c))
                         for i, c in enumerate(cfg.density_components)],
        "app_plane": [randn(6 + i, cfg.plane_shape(i, c))
                      for i, c in enumerate(cfg.app_components)],
        "app_line": [randn(9 + i, cfg.line_shape(i, c))
                     for i, c in enumerate(cfg.app_components)],
        "basis": linear(12, sum(cfg.app_components), cfg.app_dim),
    }
    sizes = cfg.mlp_sizes()
    mk = prng.split(keys[13], 6)
    mlp = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        bound = 1.0 / math.sqrt(a)
        mlp.append(prng.uniform(mk[2 * i], (b, a), minval=-bound,
                                maxval=bound, device=dev))
        mlp.append(torch.zeros((b,), device=dev) if i == len(sizes) - 2 else
                   prng.uniform(mk[2 * i + 1], (b,), minval=-bound,
                                maxval=bound, device=dev))
    params["mlp"] = mlp
    return params


class TensoRFField(nn.Module):
    """A VM field's tensors as buffers, detached, in TensoRF's layout."""

    GROUPS = ("density_plane", "density_line", "app_plane", "app_line",
              "mlp")

    def __init__(self, cfg: TensoRFConfig, params: Dict):
        super().__init__()
        self.cfg = cfg
        self.sizes = {g: len(params[g]) for g in self.GROUPS}
        for g in self.GROUPS:
            for i, t in enumerate(params[g]):
                self.register_buffer(f"{g}_{i}",
                                     t.detach().float().contiguous())
        self.register_buffer("basis", params["basis"].detach().float()
                             .contiguous())

    def group(self, g: str):
        return [getattr(self, f"{g}_{i}") for i in range(self.sizes[g])]

    def params(self) -> Dict:
        out = {g: self.group(g) for g in self.GROUPS}
        out["basis"] = self.basis
        return out

    def replica(self, device) -> "TensoRFField":
        """A copy of this field on ``device``."""
        p = self.params()
        copy = {g: [t.to(device, copy=True) for t in p[g]]
                for g in self.GROUPS}
        copy["basis"] = p["basis"].to(device, copy=True)
        return TensoRFField(self.cfg, copy)


def _normalized(points):
    """Unit-cube points -> TensoRF's [-1, 1] coordinates."""
    return points * 2.0 - 1.0


def _plane_line(xyz, planes, lines, i: int):
    """(plane features (C, n), line features (C, n)) of pair ``i`` at
    normalized points ``xyz`` (n, 3)."""
    n = xyz.shape[0]
    a, b = MAT_MODE[i]
    v = xyz[:, VEC_MODE[i]]
    cp = torch.stack([xyz[:, a], xyz[:, b]], dim=-1).view(1, -1, 1, 2)
    cl = torch.stack([torch.zeros_like(v), v], dim=-1).view(1, -1, 1, 2)
    return (F.grid_sample(planes[i], cp, align_corners=True).view(-1, n),
            F.grid_sample(lines[i], cl, align_corners=True).view(-1, n))


def density_feature(params: Dict, xyz):
    """TensoRF's ``compute_densityfeature``: (n,) at normalized points."""
    f = torch.zeros((xyz.shape[0],), device=xyz.device)
    for i in range(len(MAT_MODE)):
        p, l = _plane_line(xyz, params["density_plane"],
                           params["density_line"], i)
        f = f + torch.sum(p * l, dim=0)
    return f


def app_feature(params: Dict, xyz):
    """TensoRF's ``compute_appfeature``: (n, app_dim) at normalized points."""
    ps, ls = zip(*(_plane_line(xyz, params["app_plane"], params["app_line"],
                               i) for i in range(len(MAT_MODE))))
    return F.linear((torch.cat(ps) * torch.cat(ls)).T, params["basis"])


def positional_encoding(x, freqs: int):
    """TensoRF's ``positional_encoding``: (n, c) -> (n, 2 c freqs), channel
    c at frequency 2^f at column c * freqs + f, sines then cosines."""
    bands = 2.0 ** torch.arange(freqs, dtype=torch.float32, device=x.device)
    pts = (x[..., None] * bands).reshape(*x.shape[:-1], freqs * x.shape[-1])
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


def render_mlp(params: Dict, cfg: TensoRFConfig, feats, dirs):
    """``MLPRender_Fea``: (n, app_dim), (n, 3) -> rgb (n, 3)."""
    x = torch.cat([feats, dirs, positional_encoding(feats, cfg.fea_pe),
                   positional_encoding(dirs, cfg.view_pe)], dim=-1)
    w = params["mlp"]
    for i in range(0, len(w) - 2, 2):
        x = torch.relu(F.linear(x, w[i], w[i + 1]))
    return torch.sigmoid(F.linear(x, w[-2], w[-1]))


def query_density(params: Dict, cfg: TensoRFConfig, points):
    """points (n, 3) in the unit cube -> sigma (n,), zero outside it."""
    f = density_feature(params, _normalized(points))
    sigma = F.softplus(f + cfg.density_shift) * cfg.sigma_scale
    inside = torch.all((points >= 0.0) & (points <= 1.0), dim=-1)
    return torch.where(inside, sigma, 0.0)


def query_color(params: Dict, cfg: TensoRFConfig, points, dirs):
    """points (n, 3), unit dirs (n, 3) -> rgb (n, 3)."""
    return render_mlp(params, cfg, app_feature(params, _normalized(points)),
                      dirs)


def _chunked(fn, n: int, *xs):
    if n <= POINTS_PER_CALL:
        return fn(*xs)
    return torch.cat([fn(*(x[s:s + POINTS_PER_CALL] for x in xs))
                      for s in range(0, n, POINTS_PER_CALL)])


def field_fns(field: TensoRFField):
    """The FieldFns of a VM field in library operations (fp32, TF32 off as
    ``device.py`` sets it), chunked by ``POINTS_PER_CALL``: density(points)
    -> (sigma, geo = points) and color(points, dirs) -> rgb, traced as
    ``tensorf.density`` and ``tensorf.appearance`` (device time on the
    card)."""
    from .fields import FieldFns, replicable

    cfg = field.cfg

    def density(points):
        timed = points.device.type == "cuda"
        with trace_lib.span("tensorf.density", points=points.shape[0],
                            device=timed):
            sigma = _chunked(lambda p: query_density(field.params(), cfg, p),
                             points.shape[0], points)
        return sigma, points

    def color(points, dirs):
        timed = points.device.type == "cuda"
        with trace_lib.span("tensorf.appearance", points=points.shape[0],
                            device=timed):
            return _chunked(lambda p, d: query_color(field.params(), cfg, p,
                                                     d),
                            points.shape[0], points, dirs)

    return replicable(FieldFns(density=density, color=color),
                      lambda device: field_fns(field.replica(device)))
