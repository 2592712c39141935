"""Carry NGP weights across from the JAX package's layout.

The reference keeps a field's parameters as the pytree
``{"grid": (L, T, F), "mlps": {"density": [W...], "color": [W...]}}``
with each W a (fan_in, fan_out) matrix.  ``from_jax_params`` turns that
pytree, given as numpy arrays, into the port's ``NGPField``.
``load_cache_pickle`` reads the benchmark cache's pickle of
``(numpy params, NGPConfig)`` by attribute names: the reference's config
classes are mapped onto the port's dataclasses of the same fields, so the
reference package is never imported.  ``random_params`` draws a pytree in
that layout from a numpy seed (Glorot-uniform weights, uniform tables).
"""
from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

from .core import hashgrid, mlp
from .core.model import NGPConfig, NGPField
from .device import resolve_device

# The reference's config classes, by (module, name), and their stand-ins.
_CONFIG_CLASSES = {
    ("repro.core.model", "NGPConfig"): NGPConfig,
    ("repro.core.hashgrid", "HashGridConfig"): hashgrid.HashGridConfig,
    ("repro.core.mlp", "MLPConfig"): mlp.MLPConfig,
}
_SAFE_MODULES = ("numpy", "builtins", "copyreg", "_codecs")


def _port_config(cfg) -> NGPConfig:
    """Any object with the reference config's attributes -> NGPConfig."""
    g, n = cfg.grid, cfg.net
    grid = hashgrid.HashGridConfig(
        n_levels=g.n_levels, log2_table_size=g.log2_table_size,
        feature_dim=g.feature_dim, base_resolution=g.base_resolution,
        max_resolution=g.max_resolution)
    net = mlp.MLPConfig(
        encoding_dim=n.encoding_dim, density_hidden=n.density_hidden,
        density_layers=n.density_layers, geo_feature_dim=n.geo_feature_dim,
        sh_degree=n.sh_degree, color_hidden=n.color_hidden,
        color_layers=n.color_layers)
    return NGPConfig(grid=grid, net=net)


def from_jax_params(params_np: Dict, cfg, device=None) -> NGPField:
    """The reference's params pytree (numpy arrays) -> NGPField on
    ``device`` (the GPU unless ``device="cpu"``)."""
    dev = resolve_device(device)
    cfg = _port_config(cfg)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32, copy=True))

    field = NGPField(cfg, t(params_np["grid"]),
                     [t(w) for w in params_np["mlps"]["density"]],
                     [t(w) for w in params_np["mlps"]["color"]])
    return field.to(dev)


class _CacheUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _CONFIG_CLASSES:
            return _CONFIG_CLASSES[(module, name)]
        if module.split(".")[0] in _SAFE_MODULES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing {module}.{name}")


def load_cache_pickle(path, device=None) -> NGPField:
    """Read a benchmark-cache pickle of (numpy params, NGPConfig)."""
    with open(path, "rb") as f:
        params_np, cfg = _CacheUnpickler(f).load()
    return from_jax_params(params_np, cfg, device)


def random_params(cfg: NGPConfig, seed: int, table_scale: float = 1e-4) -> Dict:
    """Seeded numpy params in the reference layout: tables
    uniform(-table_scale, table_scale), weights Glorot-uniform."""
    rng = np.random.default_rng(seed)

    def chain(sizes):
        return [rng.uniform(-np.sqrt(6.0 / (a + b)), np.sqrt(6.0 / (a + b)),
                            (a, b)).astype(np.float32)
                for a, b in zip(sizes[:-1], sizes[1:])]

    grid = rng.uniform(-table_scale, table_scale,
                       (cfg.grid.n_levels, cfg.grid.table_size,
                        cfg.grid.feature_dim)).astype(np.float32)
    return {"grid": grid,
            "mlps": {"density": chain(cfg.net.density_sizes()),
                     "color": chain(cfg.net.color_sizes())}}
