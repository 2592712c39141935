"""Field abstraction — the composability seam of the renderer
(``repro.core.fields``).

``density(points) -> (sigma (N,), geo (N, G))`` and
``color(geo, dirs) -> rgb (N, 3)``.  The same pipeline runs the NGP
network in plain torch (``model.field_fns``), the analytic scenes
(``analytic_field_fns``) and the CUDA-kernel-backed network
(``kernels.ops.field_fns``).

A FieldFns computes where its tensors lie.  Each function that makes one
keeps beside it the recipe that rebuilds it on another device
(``replicable``), so the serving engine can run Stage A on a secondary
card with a replica of the fields (``Replicas``), where JAX moves a
jitted function's uncommitted parameters to ``jax.default_device`` by
itself.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, NamedTuple

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

    fns = FieldFns(density=density, color=color)
    # the scene builds its constants on the points' device: one FieldFns
    # serves every device
    return replicable(fns, lambda device: fns)


def replicable(fns: FieldFns, recipe: Callable) -> FieldFns:
    """``fns`` with ``recipe(device) -> FieldFns``, the same functions
    computed on ``device``, kept beside it (on its ``density`` function)
    for ``Replicas``."""
    fns.density.replicate = recipe
    return fns


class Replicas:
    """A FieldFns for each (scene, device) that Stage A runs on, built once
    by the recipe kept beside it (``replicable``) and kept: ``device`` (the
    engine's) uses ``fields`` themselves.  A kernel or NGP field's replica
    holds its own copy of the field's tensors; a FieldFns without a
    recipe raises."""

    def __init__(self, fields: Dict[str, FieldFns], device):
        self.fields = fields
        self.device = torch.device(device)
        self.built: Dict[tuple, FieldFns] = {}
        self._lock = threading.Lock()

    def on(self, scene: str, device) -> FieldFns:
        device = torch.device(device)
        if device == self.device:
            return self.fields[scene]
        with self._lock:
            fns = self.built.get((scene, device))
            if fns is None:
                recipe = getattr(self.fields[scene].density, "replicate",
                                 None)
                if recipe is None:
                    raise ValueError(
                        f"the field of scene {scene!r} keeps no recipe to "
                        f"rebuild it on {device}; build it with core.fields."
                        f"analytic_field_fns, core.model.field_fns / "
                        f"param_fns or kernels.ops.field_fns")
                fns = recipe(device)
                if device.type == "cuda":
                    # made on this thread's stream: complete before a
                    # stream of another thread reads it
                    torch.cuda.current_stream(device).synchronize()
                self.built[(scene, device)] = fns
        return fns
