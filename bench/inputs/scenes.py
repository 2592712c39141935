"""The analytic scenes and the pinhole camera, frozen for the benchmark.

A copy of the port's ``core/scene.py`` (``make_scene`` and
``look_at_camera``), kept here so that the benchmark's inputs do not move
when the program changes.  Each scene is a soft-min composition of
coloured SDF primitives in the unit cube:
``density = scale * sigmoid(-sharpness * sdf)`` and the colour of the
nearest primitive.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

SCENES = {
    "lego": (60.0, [
        ("box", ((0.5, 0.5, 0.28), (0.26, 0.26, 0.03)), (0.85, 0.75, 0.2)),
        ("box", ((0.42, 0.5, 0.38), (0.06, 0.18, 0.07)), (0.9, 0.6, 0.1)),
        ("box", ((0.62, 0.46, 0.40), (0.05, 0.05, 0.10)), (0.8, 0.2, 0.1)),
        ("sphere", ((0.56, 0.62, 0.50), 0.07), (0.2, 0.4, 0.85)),
        ("sphere", ((0.40, 0.38, 0.52), 0.05), (0.2, 0.8, 0.3)),
        ("box", ((0.52, 0.52, 0.56), (0.03, 0.12, 0.03)), (0.7, 0.7, 0.75)),
    ]),
    "hotdog": (50.0, [
        ("box", ((0.5, 0.5, 0.3), (0.3, 0.3, 0.02)), (0.95, 0.95, 0.92)),
        ("sphere", ((0.42, 0.5, 0.4), 0.1), (0.75, 0.45, 0.2)),
        ("sphere", ((0.58, 0.5, 0.4), 0.1), (0.75, 0.45, 0.2)),
        ("box", ((0.5, 0.5, 0.44), (0.16, 0.04, 0.03)), (0.85, 0.25, 0.1)),
    ]),
    "mic": (80.0, [
        ("sphere", ((0.5, 0.5, 0.62), 0.08), (0.6, 0.6, 0.65)),
        ("box", ((0.5, 0.5, 0.42), (0.015, 0.015, 0.13)), (0.3, 0.3, 0.32)),
        ("box", ((0.5, 0.5, 0.28), (0.07, 0.07, 0.012)), (0.25, 0.25, 0.28)),
    ]),
}
DENSITY_SCALE = 40.0


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


def make_scene(name: str):
    """points (N, 3) -> (sigma (N,), rgb (N, 3)) of the named scene."""
    sharpness, prims = SCENES[name]
    cols = [color for _, _, color in prims]

    def field(p):
        sd = torch.stack([_sphere_sdf(p, *args) if kind == "sphere"
                          else _box_sdf(p, *args)
                          for kind, args, _ in prims], dim=-1)
        sigma = DENSITY_SCALE * torch.max(torch.sigmoid(-sharpness * sd),
                                          dim=-1).values
        w = torch.softmax(-sharpness * sd, dim=-1)
        color = w @ torch.tensor(cols, dtype=p.dtype, device=p.device)
        return sigma, torch.clamp(color, 0.0, 1.0)

    return field


@dataclasses.dataclass(frozen=True)
class Camera:
    height: int
    width: int
    focal: float                 # in pixels
    c2w_rot: np.ndarray          # (3, 3) float32, columns right, up, forward
    origin: np.ndarray           # (3,) float32


def look_at_camera(height: int, width: int, theta: float, phi: float,
                   radius: float = 1.2, center=(0.5, 0.5, 0.42),
                   fov_deg: float = 45.0) -> Camera:
    center = np.asarray(center, np.float32)
    eye = center + radius * np.asarray(
        [np.cos(phi) * np.cos(theta), np.cos(phi) * np.sin(theta),
         np.sin(phi)], np.float32)
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray([0.0, 0.0, 1.0], np.float32))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    rot = np.stack([right, up, fwd], axis=-1).astype(np.float32)
    focal = 0.5 * width / np.tan(0.5 * np.deg2rad(fov_deg))
    return Camera(height, width, float(focal), rot, eye.astype(np.float32))
