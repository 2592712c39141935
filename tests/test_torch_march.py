"""Port parity: the Phase-II march, on the JAX fused-march kernel's cases.

The port's fused backend (the kernel wrapper's CPU path, i.e. the plain
version of the CUDA kernel) and its reference backend (the chunked march
over the plain-torch field) are held against the JAX reference march
(here) and the JAX Pallas fused march in interpret mode
(test_torch_march_fused.py): rgb/acc/depth within rtol 1e-4 / atol 1e-5,
chunks_done and per-ray chunks exactly equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpl
from repro.core import scene as jsc
from repro.core.model import NGPConfig as JNGPConfig, init_ngp
from repro.core.model import field_fns as j_field_fns
from repro.kernels import ops as jops
from repro_torch import params as tparams
from repro_torch.core import model as tmodel
from repro_torch.core import pipeline as tpl
from repro_torch.kernels import ops as tops


def _hot(params):
    """Non-negative features and amplified non-negative density weights:
    sigma hits trunc_exp's clip inside the cube, rays saturate at once."""
    hot = dict(params)
    hot["grid"] = jnp.abs(params["grid"]) + 0.5
    hot["mlps"] = dict(params["mlps"])
    hot["mlps"]["density"] = [jnp.abs(w) * 4.0 for w in params["mlps"]["density"]]
    return hot


def _blocked_rays(n_blocks, block_size, theta=0.6, phi=0.4):
    cam = jsc.look_at_camera(n_blocks * block_size // 8, 8, theta=theta, phi=phi)
    o, d = jsc.camera_rays(cam)
    return (np.asarray(o).reshape(n_blocks, block_size, 3),
            np.asarray(d).reshape(n_blocks, block_size, 3))


def _saturating_block(mixed):
    o = np.tile(np.asarray([0.45, 0.45, -0.3], np.float32), (8, 1))
    o += np.linspace(0.0, 0.1, 8, dtype=np.float32)[:, None] * np.asarray(
        [1.0, 1.0, 0.0], np.float32)
    if mixed:            # half the rays miss the cube and ride the budget out
        o[4:] = np.asarray([0.5, 0.5, -2.0], np.float32)
    d = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (8, 1))
    return o[None], d[None]


def _case(name):
    """(cfg, params-transform, o_b, d_b, budgets, acfg kwargs, density_only)"""
    small = JNGPConfig.small()
    if name == "budget_below_chunk":
        return (small, None, *_blocked_rays(1, 32), [7], {}, False)
    if name == "ragged_budgets":
        return (small, None, *_blocked_rays(3, 32), [16, 48, 33], {}, False)
    if name == "group3":
        return (small, None, *_blocked_rays(2, 32), [32, 21], {"group": 3}, False)
    if name == "saturated_block":
        return (small, _hot, *_saturating_block(False), [192],
                {"block_size": 8}, False)
    if name == "pad_blocks":
        o = np.zeros((1, 8, 3), np.float32)
        d = np.tile(np.asarray([0.0, 0.0, -1.0], np.float32), (1, 8, 1))
        return (small, None, o, d, [1], {"block_size": 8}, False)
    if name == "density_only":
        return (small, None, *_blocked_rays(2, 32), [48, 33], {}, True)
    if name == "odd_levels":
        cfg = JNGPConfig.make(n_levels=5, log2_table_size=10, max_resolution=256)
        return (cfg, None, *_blocked_rays(2, 32), [48, 21], {}, False)
    if name == "per_ray_early_exit":
        return (small, _hot, *_saturating_block(True), [192],
                {"block_size": 8, "per_ray_early_exit": True}, False)
    if name == "no_early_termination":
        return (small, None, *_blocked_rays(1, 32), [48],
                {"early_termination": False}, False)
    raise KeyError(name)


CASES = ["budget_below_chunk", "ragged_budgets", "group3", "saturated_block",
         "pad_blocks", "density_only", "odd_levels", "per_ray_early_exit",
         "no_early_termination"]


def _jax_march(name, backend):
    cfg, transform, o_b, d_b, budgets, kw, density_only = _case(name)
    params = init_ngp(jax.random.PRNGKey(0), cfg)
    if transform is not None:
        params = transform(params)
    acfg = dict(block_size=32, chunk=16, group=2, march_backend=backend)
    acfg.update(kw)
    fns = (jops.field_fns(params, cfg) if backend == "fused"
           else j_field_fns(params, cfg))
    out = jpl.march_blocks(fns, jpl.ASDRConfig(**acfg), jnp.asarray(o_b),
                           jnp.asarray(d_b), jnp.asarray(budgets, jnp.int32),
                           density_only=density_only)
    return tuple(np.asarray(x) for x in out), params


_jax_reference = functools.lru_cache(maxsize=None)(
    lambda name: _jax_march(name, "reference"))


def port_march(name, backend, params):
    """The port's march of a case on the CPU, over the same params."""
    cfg, _, o_b, d_b, budgets, kw, density_only = _case(name)
    field = tparams.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    acfg = dict(block_size=32, chunk=16, group=2, march_backend=backend)
    acfg.update(kw)
    fns = tops.field_fns(field) if backend == "fused" else tmodel.field_fns(field)
    return tpl.march_blocks(fns, tpl.ASDRConfig(**acfg), torch.tensor(o_b),
                            torch.tensor(d_b),
                            torch.tensor(budgets, dtype=torch.int32),
                            density_only=density_only)


def check_case(name, got, want):
    for i, what in enumerate(("rgb", "acc", "depth")):
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=1e-4,
                                   atol=1e-5, err_msg=what)
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    np.testing.assert_array_equal(got[4].numpy(), want[4])
    _, _, _, _, budgets, kw, _ = _case(name)
    chunks = got[3].numpy()
    full = -(-np.asarray(budgets) // kw.get("chunk", 16))
    if name in ("saturated_block", "per_ray_early_exit"):
        assert (chunks < full).all(), "early termination never fired"
    if name == "per_ray_early_exit":
        rc = got[4].numpy()[0]
        assert (rc[:4] < chunks[0]).all() and (rc[4:] == chunks[0]).all()
    if name == "no_early_termination":
        assert (chunks == full).all()
    if name == "pad_blocks":
        np.testing.assert_allclose(got[1].numpy(), 0.0, atol=1e-6)
        np.testing.assert_allclose(got[0].numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("backend", ["fused", "reference"])
@pytest.mark.parametrize("name", CASES)
def test_march_matches_jax_reference(name, backend):
    want, params = _jax_reference(name)
    check_case(name, port_march(name, backend, params), want)


def test_fused_backend_without_resources_takes_reference():
    """march_backend='fused' on a field with no fused resources (analytic)
    runs the reference march."""
    from repro_torch.core import fields, scene
    fns = fields.analytic_field_fns(scene.make_scene("mic"))
    o_b, d_b = (torch.tensor(a) for a in _blocked_rays(2, 32))
    budgets = torch.tensor([48, 16], dtype=torch.int32)
    got = tpl.march_blocks(fns, tpl.ASDRConfig(block_size=32, chunk=16,
                                               march_backend="fused"),
                           o_b, d_b, budgets)
    want = tpl.march_blocks(fns, tpl.ASDRConfig(block_size=32, chunk=16),
                            o_b, d_b, budgets)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["auto", "resident", "streamed"])
def test_table_supply_values_mean_one_supply(mode):
    """Every march_table_streaming value runs the same march on the GPU's
    one table supply; anything else is refused."""
    cfg = JNGPConfig.small()
    params = init_ngp(jax.random.PRNGKey(0), cfg)
    field = tparams.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    fns = tops.field_fns(field)
    o_b, d_b = (torch.tensor(a) for a in _blocked_rays(1, 32))
    budgets = torch.tensor([33], dtype=torch.int32)
    kw = dict(block_size=32, chunk=16, march_backend="fused")
    got = tpl.march_blocks(fns, tpl.ASDRConfig(march_table_streaming=mode, **kw),
                           o_b, d_b, budgets)
    want = tpl.march_blocks(fns, tpl.ASDRConfig(**kw), o_b, d_b, budgets)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="march_table_streaming"):
        tpl.march_blocks(fns, tpl.ASDRConfig(march_table_streaming="bogus", **kw),
                         o_b, d_b, budgets)
