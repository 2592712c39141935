"""Analytic scenes, the pinhole camera and ray sampling (``repro.core.scene``).

The analytic scenes are smooth compositions of coloured SDF primitives in
the unit cube with an exact density field, so the pipeline can be checked
without training error.  ``sample_points`` takes its stratification jitter
as a tensor of uniform [0, 1) draws instead of a random key, so a test can
hand both frameworks the same numbers.

``linspace`` and ``camera_rays`` reproduce the reference's float32
arithmetic bit for bit, because count maps and block layouts downstream
are compared exactly: XLA computes ``linspace`` as
``start*(1-i*r) + i*(stop*r)`` with ``r = 1/(num-1)``, and sums the
camera's products in order.  Each operation is rounded on its own, as the
reference computes them with its backend optimisation off (the test
suite's setting); an optimising backend may contract a multiply and an
add into one fused multiply-add and move some values by an ulp.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from . import rendering
from ..device import resolve_device

Field = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

# Ray-march bounds: scenes live in the unit cube; near/far fixed.
NEAR, FAR = 0.2, 2.2


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """float32 ``linspace`` equal bit for bit to the reference's, computed
    on the host in float32 and moved to ``device``; ``num`` values
    including both ends."""
    if num == 1:
        out = np.asarray([start], np.float32)
    else:
        div = num - 1
        i = np.arange(div, dtype=np.float32)
        s, e = np.float32(start), np.float32(stop)
        r = np.float32(1.0) / np.float32(div)
        body = s * (np.float32(1.0) - i * r) + i * (e * r)
        out = np.concatenate([body, np.asarray([e], np.float32)])
    return torch.from_numpy(out).to(device)


def _sphere_sdf(p, center, radius):
    c = torch.tensor(center, dtype=p.dtype, device=p.device)
    return torch.linalg.vector_norm(p - c, dim=-1) - radius


def _box_sdf(p, center, half):
    c = torch.tensor(center, dtype=p.dtype, device=p.device)
    h = torch.tensor(half, dtype=p.dtype, device=p.device)
    q = torch.abs(p - c) - h
    outside = torch.linalg.vector_norm(torch.clamp(q, min=0.0), dim=-1)
    inside = torch.clamp(torch.max(q, dim=-1).values, max=0.0)
    return outside + inside


def _primitives_to_field(prims, sharpness=60.0, density_scale=40.0) -> Field:
    """Soft-min composition: density = scale * sigmoid(-sharpness * sdf)."""

    def field(p):
        sds, cols = [], []
        for kind, args, color in prims:
            sds.append(_sphere_sdf(p, *args) if kind == "sphere"
                       else _box_sdf(p, *args))
            cols.append(color)
        sd = torch.stack(sds, dim=-1)                      # (N, P)
        occ = torch.sigmoid(-sharpness * sd)
        sigma = density_scale * torch.max(occ, dim=-1).values
        w = torch.softmax(-sharpness * sd, dim=-1)         # nearest prim
        color = w @ torch.tensor(cols, dtype=p.dtype, device=p.device)
        return sigma, torch.clamp(color, 0.0, 1.0)

    return field


def make_scene(name: str = "lego") -> Field:
    if name == "lego":
        prims = [
            ("box", ((0.5, 0.5, 0.28), (0.26, 0.26, 0.03)), (0.85, 0.75, 0.2)),
            ("box", ((0.42, 0.5, 0.38), (0.06, 0.18, 0.07)), (0.9, 0.6, 0.1)),
            ("box", ((0.62, 0.46, 0.40), (0.05, 0.05, 0.10)), (0.8, 0.2, 0.1)),
            ("sphere", ((0.56, 0.62, 0.50), 0.07), (0.2, 0.4, 0.85)),
            ("sphere", ((0.40, 0.38, 0.52), 0.05), (0.2, 0.8, 0.3)),
            ("box", ((0.52, 0.52, 0.56), (0.03, 0.12, 0.03)), (0.7, 0.7, 0.75)),
        ]
        return _primitives_to_field(prims)
    if name == "hotdog":
        prims = [
            ("box", ((0.5, 0.5, 0.3), (0.3, 0.3, 0.02)), (0.95, 0.95, 0.92)),
            ("sphere", ((0.42, 0.5, 0.4), 0.1), (0.75, 0.45, 0.2)),
            ("sphere", ((0.58, 0.5, 0.4), 0.1), (0.75, 0.45, 0.2)),
            ("box", ((0.5, 0.5, 0.44), (0.16, 0.04, 0.03)), (0.85, 0.25, 0.1)),
        ]
        return _primitives_to_field(prims, sharpness=50.0)
    if name == "mic":  # mostly empty — background-heavy like the paper's Mic
        prims = [
            ("sphere", ((0.5, 0.5, 0.62), 0.08), (0.6, 0.6, 0.65)),
            ("box", ((0.5, 0.5, 0.42), (0.015, 0.015, 0.13)), (0.3, 0.3, 0.32)),
            ("box", ((0.5, 0.5, 0.28), (0.07, 0.07, 0.012)), (0.25, 0.25, 0.28)),
        ]
        return _primitives_to_field(prims, sharpness=80.0)
    raise ValueError(f"unknown scene {name!r}")


@dataclasses.dataclass(frozen=True)
class Camera:
    height: int
    width: int
    focal: float  # in pixels
    # camera-to-world rotation (3,3) and origin (3,), host numpy float32
    c2w_rot: np.ndarray
    origin: np.ndarray


def look_at_camera(
    height: int, width: int, theta: float, phi: float, radius: float = 1.2,
    center=(0.5, 0.5, 0.42), fov_deg: float = 45.0,
) -> Camera:
    center = np.asarray(center, np.float32)
    eye = center + radius * np.asarray(
        [np.cos(phi) * np.cos(theta), np.cos(phi) * np.sin(theta), np.sin(phi)],
        np.float32,
    )
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray([0.0, 0.0, 1.0], np.float32))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    rot = np.stack([right, up, fwd], axis=-1).astype(np.float32)  # cols
    focal = 0.5 * width / np.tan(0.5 * np.deg2rad(fov_deg))
    return Camera(height, width, float(focal), rot, eye.astype(np.float32))


def camera_rays(cam: Camera, device=None):
    """Returns (origins (H*W, 3), dirs (H*W, 3)) — dirs are unit vectors."""
    dev = resolve_device(device)
    j, i = torch.meshgrid(
        torch.arange(cam.height, dtype=torch.float32, device=dev),
        torch.arange(cam.width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    x = (i - cam.width * 0.5 + 0.5) / cam.focal
    y = -(j - cam.height * 0.5 + 0.5) / cam.focal
    rot = torch.from_numpy(np.asarray(cam.c2w_rot, np.float32)).to(dev)
    # d_cam @ rot.T and the norm, summed over k in order; the square root
    # is taken in float64 so it rounds correctly once cast back (torch's
    # vectorised float32 sqrt on the CPU may not)
    d = x[..., None] * rot[:, 0] + y[..., None] * rot[:, 1] + rot[:, 2]
    a, b, c = d[..., :1], d[..., 1:2], d[..., 2:]
    d = d / torch.sqrt((a * a + b * b + c * c).double()).float()
    o = torch.from_numpy(np.asarray(cam.origin, np.float32)).to(dev)
    o = o.expand(d.shape)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def sample_points(origins, dirs, n_samples: int, jitter=None):
    """Stratified (if ``jitter``) or midpoint sampling along each ray.

    ``jitter``: optional (R, n_samples) uniform [0, 1) draws; each sample
    moves by ``(u - 0.5) * (FAR - NEAR) / n_samples``.
    Returns points (R, S, 3), deltas (R, S), ts (R, S).
    """
    R = origins.shape[0]
    edges = linspace(NEAR, FAR, n_samples + 1, device=origins.device)
    mids = 0.5 * (edges[:-1] + edges[1:])
    if jitter is not None:
        ts = mids[None, :] + (jitter - 0.5) * ((FAR - NEAR) / n_samples)
    else:
        ts = mids[None, :].expand(R, n_samples)
    deltas = torch.full((R, n_samples), (FAR - NEAR) / n_samples,
                        device=origins.device)
    pts = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
    return pts, deltas, ts


def render_reference(field: Field, origins, dirs, n_samples: int = 512):
    """Ground-truth render by finely marching the analytic field."""
    pts, deltas, _ = sample_points(origins, dirs, n_samples)
    flat = pts.reshape(-1, 3)
    sigma, color = field(flat)
    inside = torch.all((flat >= 0.0) & (flat <= 1.0), dim=-1)
    sigma = torch.where(inside, sigma, 0.0).reshape(pts.shape[:2])
    color = color.reshape(pts.shape[:2] + (3,))
    rgb, acc, _ = rendering.composite(sigma, color, deltas)
    return rgb, acc
