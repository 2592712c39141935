"""The system under test, the PyTorch/CUDA port (``repro_torch``), built
from a configuration file and the benchmark's fitted params: the kernel
field (``kernels.ops.field_fns``) that carries the fused march, the ASDR
settings with ``march_backend="fused"``, and the port's camera."""
from __future__ import annotations

import torch

from repro_torch.core import hashgrid, mlp, model
from repro_torch.core import scene as port_scene
from repro_torch.core.pipeline import ASDRConfig
from repro_torch.kernels import ops


def ngp_config(cfg: dict) -> model.NGPConfig:
    grid = hashgrid.HashGridConfig(**cfg["grid"])
    net = mlp.MLPConfig(encoding_dim=grid.output_dim, **cfg["mlp"])
    return model.NGPConfig(grid=grid, net=net)


def asdr_config(cfg: dict) -> ASDRConfig:
    a = dict(cfg["asdr"])
    a["candidates"] = tuple(a["candidates"])
    return ASDRConfig(**a)


def kernel_field(cfg: dict, params: dict):
    """The port's kernel-backed FieldFns over its own copy of ``params``."""
    field = model.NGPField(ngp_config(cfg), params["grid"].clone(),
                           [w.clone() for w in params["density"]],
                           [w.clone() for w in params["color"]])
    return ops.field_fns(field)


def camera(cam) -> port_scene.Camera:
    return port_scene.Camera(cam.height, cam.width, cam.focal, cam.c2w_rot,
                             cam.origin)


def frame_outputs(img: torch.Tensor, stats: dict) -> dict:
    """What the comparison reads of a ``render_asdr_image`` frame."""
    return {"image": img, "counts": stats["counts"],
            "budgets": stats["budgets"], "chunks": stats["chunks_per_block"],
            "ray_chunks": stats["ray_chunks_per_block"],
            "depth": stats["term_depth"],
            "probe_samples": stats["probe_samples"]}
