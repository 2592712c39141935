"""Port parity: the NGP's initialisation, the hash grid's extras and the
params bridge against the reference.  The init draws through
``repro_torch.prng`` (the reference's ``jax.random``), so for the same
key it equals the reference's init value for value; each leaf is also
held to its uniform law (mean and variance within six standard errors).
The rest exactly, or to the port's float32 contract (rtol 1e-4 /
atol 1e-5) where it renders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashgrid as jhg
from repro.core import mlp as jmlp
from repro.core import model as jmodel
from repro.core import scene as jsc
from repro_torch import params as tparams
from repro_torch import prng
from repro_torch.core import hashgrid as thg
from repro_torch.core import mlp as tmlp
from repro_torch.core import model as tmodel
from repro_torch.core import scene as tsc

CONFIGS = {"small": jmodel.NGPConfig.small(),
           "small_paper_mlp": jmodel.NGPConfig.small(paper_mlp=True),
           "full": jmodel.NGPConfig.make(paper_mlp=True)}


def _port(jcfg):
    return tparams._port_config(jcfg)


def _leaves(tree):
    return [np.asarray(x.numpy() if torch.is_tensor(x) else x)
            for x in jax.tree.leaves(tree)]


def _bounds(jcfg):
    """Each leaf's half-width: 1e-4 for the tables, Glorot for weights."""
    sizes = _port(jcfg).net
    scale = [1e-4]
    for chain in (sizes.color_sizes(), sizes.density_sizes()):  # jax order
        scale += [np.sqrt(6.0 / (a + b)) for a, b in zip(chain[:-1], chain[1:])]
    return scale


def _assert_uniform(x, half):
    """x drawn from uniform(-half, half): in range, and mean and variance
    within six standard errors of the law's."""
    x = x.astype(np.float64).reshape(-1)
    n, var = x.size, half ** 2 / 3.0
    assert -half <= x.min() and x.max() <= half
    assert x.max() > 0.9 * half and x.min() < -0.9 * half
    assert abs(x.mean()) <= 6.0 * np.sqrt(var / n)
    assert abs(x.var() / var - 1.0) <= 6.0 * np.sqrt(0.8 / n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_ngp_matches_reference_layout_and_law(name):
    jcfg = CONFIGS[name]
    jp = jmodel.init_ngp(jax.random.PRNGKey(0), jcfg)
    tp = tmodel.init_ngp(_port(jcfg), prng.PRNGKey(0), device="cpu")
    assert sorted(tp) == ["grid", "mlps"]
    assert sorted(tp["mlps"]) == ["color", "density"]
    want, got = _leaves(jp), _leaves(tp)
    assert [(w.shape, w.dtype) for w in want] == [(g.shape, g.dtype)
                                                  for g in got]
    for w, g, half in zip(want, got, _bounds(jcfg)):
        _assert_uniform(w, half)
        np.testing.assert_array_equal(g, w)


def test_init_parts_match_reference_shapes():
    jcfg = CONFIGS["small_paper_mlp"]
    tcfg = _port(jcfg)
    key = prng.PRNGKey(1)
    grid = thg.init_hashgrid(tcfg.grid, key, device="cpu")
    jgrid = jhg.init_hashgrid(jax.random.PRNGKey(1), jcfg.grid)
    assert (tuple(grid.shape), grid.dtype) == (jgrid.shape, torch.float32)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jgrid))
    mlps = tmlp.init_mlps(tcfg.net, key, device="cpu")
    jmlps = jmlp.init_mlps(jax.random.PRNGKey(1), jcfg.net)
    for k in ("density", "color"):
        assert [tuple(w.shape) for w in mlps[k]] == [w.shape for w in jmlps[k]]
        for w, jw in zip(mlps[k], jmlps[k]):
            np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    w = tmlp._dense_init(prng.PRNGKey(2), 31, 128, "cpu")
    _assert_uniform(w.numpy(), np.sqrt(6.0 / 159))
    # one key: the same draw
    again = thg.init_hashgrid(tcfg.grid, prng.PRNGKey(1), device="cpu")
    assert torch.equal(grid, again)


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tcfg = _port(CONFIGS["small"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init_ngp(tcfg, prng.PRNGKey(0))
    field = tmodel.NGPField.from_params(tcfg, tmodel.init_ngp(
        tcfg, prng.PRNGKey(0), device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.render_image(field, tsc.look_at_camera(4, 4, 0.7, 0.5))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_grid_config_extras_match(name):
    jg, tg = CONFIGS[name].grid, _port(CONFIGS[name]).grid
    assert tg.level_resolutions() == jg.level_resolutions()
    assert thg.storage_utilization(tg) == jhg.storage_utilization(jg)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_flops_per_sample_matches(name):
    """The repair: the port's flops_per_sample returns color_fraction."""
    want = jmlp.flops_per_sample(CONFIGS[name].net)
    assert tmlp.flops_per_sample(_port(CONFIGS[name]).net) == want
    assert "color_fraction" in want


def _voxel_points(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    pts[:4] = [[0, 0, 0], [1, 1, 1], [1, 0, 0.5], [0.9999999, 1, 0]]
    return pts


def test_level_voxel_ids_match_exactly_at_the_small_config():
    jg, tg = CONFIGS["small"].grid, _port(CONFIGS["small"]).grid
    pts = _voxel_points(3000, 0)
    want = np.asarray(jhg.level_voxel_ids(jnp.asarray(pts), jg))
    got = thg.level_voxel_ids(torch.from_numpy(pts), tg)
    assert got.dtype == torch.int64 and got.shape == (3000, jg.n_levels)
    np.testing.assert_array_equal(got.numpy(), want)


def test_level_voxel_ids_match_mod_2_32_at_the_full_config():
    """The reference's ids are int32 (no 64-bit mode) and wrap at res 2048;
    the port's are the true ids, equal mod 2^32."""
    jg, tg = CONFIGS["full"].grid, _port(CONFIGS["full"]).grid
    pts = _voxel_points(3000, 1)
    want = np.asarray(jhg.level_voxel_ids(jnp.asarray(pts), jg))
    got = thg.level_voxel_ids(torch.from_numpy(pts), tg).numpy()
    np.testing.assert_array_equal(got & 0xFFFFFFFF,
                                  want.astype(np.int64) & 0xFFFFFFFF)
    assert got.max() > 2 ** 31 and want.dtype == np.int32
    assert got.max() <= tg.level_resolution(tg.n_levels - 1) ** 3 - 1


def _small_params(seed=3):
    cfg = CONFIGS["small"]
    p = jax.tree.map(np.asarray, jmodel.init_ngp(jax.random.PRNGKey(seed), cfg))
    # tables at 1e-4 render the blank background; widen them so the render
    # has structure (as test_torch_frame.py does)
    p["grid"] = p["grid"] * np.float32(3e3)
    return cfg, p


def test_params_round_trip_is_exact():
    cfg, p = _small_params()
    field = tparams.from_jax_params(p, cfg, device="cpu")
    back = tparams.to_jax_params(field)
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    again = tmodel.NGPField.from_params(field.cfg, field.params())
    assert all(torch.equal(a, b) for a, b in zip(again.buffers(),
                                                 field.buffers()))


def test_from_params_detaches():
    tcfg = _port(CONFIGS["small"])
    p = tmodel.init_ngp(tcfg, prng.PRNGKey(0), device="cpu")
    p["grid"].requires_grad_()
    field = tmodel.NGPField.from_params(tcfg, p)
    assert not any(b.requires_grad for b in field.buffers())


@pytest.mark.parametrize("chunk", [200, 4096])
def test_render_image_matches_reference(chunk):
    """24x24 at 32 samples, in ragged chunks of 200 rays and in one."""
    cfg, p = _small_params()
    field = tparams.from_jax_params(p, cfg, device="cpu")
    jcam = jsc.look_at_camera(24, 24, theta=0.7, phi=0.5)
    tcam = tsc.look_at_camera(24, 24, theta=0.7, phi=0.5)
    want = np.asarray(jmodel.render_image(p, cfg, jcam, n_samples=32,
                                          chunk=chunk))
    got = tmodel.render_image(field, tcam, n_samples=32, chunk=chunk,
                              device="cpu")
    assert tuple(got.shape) == want.shape == (24, 24, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert want.std() > 1e-3                  # not a blank frame


def test_query_field_matches_reference():
    cfg, p = _small_params()
    rng = np.random.default_rng(4)
    pts = rng.uniform(-0.1, 1.1, (200, 3)).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    js, jc = jmodel.query_field(p, cfg, jnp.asarray(pts), jnp.asarray(dirs))
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p)
    ts, tc = tmodel.query_field(tp, _port(cfg), torch.from_numpy(pts),
                                torch.from_numpy(dirs))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
