"""Port parity: the hash-grid encode (plain torch and the kernel wrapper's
CPU path) against the JAX reference and its Pallas kernel (interpret)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashgrid as jhg
from repro.core.model import NGPConfig as JNGPConfig, init_ngp
from repro.kernels import ops as jops
from repro_torch.core import hashgrid as thg
from repro_torch.kernels import hash_encode as the
from repro_torch.kernels import ops as tops

# the port's float32 contract (rtol 1e-4, atol 1e-5): the reference sums
# the 8 corners in another order, and points outside the cube extrapolate
# the trilinear weights, which amplifies that rounding
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def small():
    cfg = JNGPConfig.small()
    params = init_ngp(jax.random.PRNGKey(0), cfg)
    tables = np.asarray(params["grid"]) * np.float32(1e3)
    return cfg, tables


def _grid_cfg(jcfg):
    g = jcfg.grid
    return thg.HashGridConfig(g.n_levels, g.log2_table_size, g.feature_dim,
                              g.base_resolution, g.max_resolution)


def _points(kind, n=64, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "inside":
        return rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    if kind == "outside":
        return rng.uniform(-0.3, 1.3, (n, 3)).astype(np.float32)
    corners = np.stack(np.meshgrid([0.0, 1.0], [0.0, 1.0], [0.0, 1.0],
                                   indexing="ij"), -1).reshape(-1, 3)
    return np.concatenate([corners, np.zeros((1, 3)), np.ones((1, 3)),
                           [[1.0, 0.5, 0.0], [0.0, 1.0, 0.5]]]).astype(np.float32)


@pytest.mark.parametrize("kind", ["inside", "outside", "faces"])
def test_encode_matches_reference(small, kind):
    cfg, tables = small
    pts = _points(kind)
    want = np.asarray(jhg.encode(jnp.asarray(pts), jnp.asarray(tables),
                                 cfg.grid))
    got = thg.encode(torch.from_numpy(pts), torch.from_numpy(tables),
                     _grid_cfg(cfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["inside", "outside", "faces"])
def test_kernel_plain_matches_pallas(small, kind):
    """The CUDA kernel's plain version (the wrapper's CPU path) against the
    Pallas kernel in interpret mode."""
    cfg, tables = small
    pts = _points(kind, seed=1)
    want = np.asarray(jops.hash_encode(jnp.asarray(pts), jnp.asarray(tables),
                                       cfg.grid))
    got = tops.hash_encode(torch.from_numpy(pts), torch.from_numpy(tables),
                           _grid_cfg(cfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_full_config_resolution_pins_uint32_wrap():
    """Level resolutions up to 2048 make the primes' products wrap uint32:
    the int64-and-mask hash must pick the reference's rows.  Each row of a
    (L, T, 1) table holds its own index, so the encode of a point exactly
    on a vertex returns the row index the hash chose."""
    jcfg = JNGPConfig.make()                       # 16 x 2^19, res 16..2048
    L, T = jcfg.grid.n_levels, jcfg.grid.table_size
    tables = np.broadcast_to(np.arange(T, dtype=np.float32)[None, :, None],
                             (L, T, 1))
    res = jcfg.grid.level_resolution(L - 1)
    assert res == 2048 and not jcfg.grid.level_is_dense(L - 1)
    verts = np.asarray([[2047, 2047, 2047], [1, 2046, 1023], [2000, 3, 1500],
                        [1024, 1024, 1024]], np.float32) / np.float32(res)
    for level in (0, L // 2, L - 1):
        r = jcfg.grid.level_resolution(level)
        dense = jcfg.grid.level_is_dense(level)
        want = np.asarray(jhg.encode_level(jnp.asarray(verts),
                                           jnp.asarray(tables[level]), r, dense))
        got = thg.encode_level(torch.from_numpy(verts),
                               torch.from_numpy(tables[level].copy()), r,
                               dense).numpy()
        np.testing.assert_array_equal(got, want)
    # the raw hash of the largest coordinates a 2048 level reaches
    coords = np.asarray([[2048, 2048, 2048], [2047, 1, 2048], [0, 2048, 17]],
                        np.int64)
    want = np.asarray(jhg.level_indices(jnp.asarray(coords, jnp.int32), 2048,
                                        False, T))
    got = thg.level_indices(torch.from_numpy(coords), 2048, False, T).numpy()
    np.testing.assert_array_equal(got, want)


def test_grid_meta_rows(small):
    cfg, _ = small
    meta = the.grid_meta(_grid_cfg(cfg)).numpy()
    want = np.asarray(jops.grid_meta(cfg.grid))[:, :3]
    np.testing.assert_array_equal(meta, want)
