"""Port parity: the locality profiles and the cache simulation
(``repro.core.reuse``) on the same points, at the small config and at the
full config's levels.  Integer outputs (addresses, counts) exactly; rates
and cosines computed from equal counts or equal numpy inputs, so equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reuse as jre
from repro.core.model import NGPConfig as JNGPConfig
from repro_torch.core import hashgrid as thg
from repro_torch.core import reuse as tre
from repro_torch.core import scene as tsc


def _grid(jcfg):
    g = jcfg.grid
    return jcfg.grid, thg.HashGridConfig(g.n_levels, g.log2_table_size,
                                         g.feature_dim, g.base_resolution,
                                         g.max_resolution)


def _ray(seed, n=192):
    """``n`` samples from NEAR to FAR along a ray aimed into the cube (the
    profiles' usual input); its ends lie outside the cube."""
    rng = np.random.default_rng(seed)
    o = np.asarray([0.5, 0.5, 0.42]) + 1.2 * rng.normal(size=3) / 2
    target = rng.uniform(0.3, 0.7, 3)
    d = (target - o) / np.linalg.norm(target - o)
    ts = np.linspace(tsc.NEAR, tsc.FAR, n)
    return (o[None] + ts[:, None] * d[None]).astype(np.float32)


@pytest.fixture(scope="module", params=["small", "full"])
def cfgs(request):
    return _grid(JNGPConfig.small() if request.param == "small"
                 else JNGPConfig.make())


def test_hash_address_trace_matches(cfgs):
    jg, tg = cfgs
    pts = _ray(0)
    for level in range(jg.n_levels):
        want = jre.hash_address_trace(jnp.asarray(pts), jg, level)
        got = tre.hash_address_trace(pts, tg, level, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert got.shape == (pts.shape[0], 8)


def test_adjacent_color_cosine_matches():
    rng = np.random.default_rng(1)
    colors = rng.uniform(0, 1, (6, 40, 3)).astype(np.float32)
    colors[0, :5] = 0.0                   # black samples: the 1e-9 guard
    np.testing.assert_array_equal(
        tre.adjacent_color_cosine(torch.from_numpy(colors)),
        jre.adjacent_color_cosine(jnp.asarray(colors)))


def test_voxel_repetition_profiles_match():
    """At the small config the reference's int32 voxel ids do not wrap."""
    jg, tg = _grid(JNGPConfig.small())
    a, b = _ray(2), _ray(2) + np.float32(2e-3)
    np.testing.assert_array_equal(
        tre.inter_ray_repetition(a, b, tg, device="cpu"),
        jre.inter_ray_repetition(jnp.asarray(a), jnp.asarray(b), jg))
    got = tre.intra_ray_max_voxel_count(a, tg, device="cpu")
    np.testing.assert_array_equal(
        got, jre.intra_ray_max_voxel_count(jnp.asarray(a), jg))
    assert got[0] > got[-1] >= 1


@pytest.mark.parametrize("items", [0, 1, 3, 8, 64])
def test_lru_cache_hit_rate_matches(items):
    addr = np.random.default_rng(3).integers(0, 20, 500)
    assert tre.lru_cache_hit_rate(addr, items) == jre.lru_cache_hit_rate(
        addr, items)


def test_cache_sweep_matches(cfgs):
    jg, tg = cfgs
    pts = _ray(4, n=96)
    want = jre.cache_sweep(jnp.asarray(pts), jg, sizes=(0, 2, 8, 32))
    got = tre.cache_sweep(pts, tg, sizes=(0, 2, 8, 32), device="cpu")
    assert sorted(got) == sorted(want)
    for s in want:
        np.testing.assert_array_equal(got[s], want[s])


@pytest.mark.parametrize("window", [1, 7, 64, 1000])
def test_dedup_window_rate_matches(cfgs, window):
    jg, tg = cfgs
    pts = _ray(5)
    for level in (0, jg.n_levels // 2, jg.n_levels - 1):
        assert tre.dedup_window_rate(pts, tg, window, level, device="cpu") \
            == jre.dedup_window_rate(jnp.asarray(pts), jg, window, level)


def test_gather_bytes_matches(cfgs):
    jg, tg = cfgs
    for n, rate, b in ((1, 0.0, 4), (12345, 0.37, 4), (640000, 0.5, 2)):
        assert tre.gather_bytes(n, tg, rate, b) == jre.gather_bytes(
            n, jg, rate, b)


def test_profiles_default_to_the_gpu():
    _, tg = _grid(JNGPConfig.small())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tre.hash_address_trace(_ray(0), tg, 0)
