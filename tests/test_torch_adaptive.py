"""Port parity: adaptive sampling, block sort, decoupling, rendering and
the camera, against the JAX reference.  Count maps, block order and
budgets are held exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import decouple as jdec
from repro.core import pipeline as jpl
from repro.core import rendering as jr
from repro.core import scene as jsc
from repro_torch.core import adaptive as tad
from repro_torch.core import decouple as tdec
from repro_torch.core import pipeline as tpl
from repro_torch.core import rendering as tr
from repro_torch.core import scene as tsc

RTOL, ATOL = 1e-4, 1e-5
LADDER = np.asarray([12, 24, 48, 96, 192], np.int32)


@pytest.mark.parametrize("start,stop,num", [(0.0, 11.0, 48), (0.0, 159.0, 800),
                                            (0.2, 2.2, 193), (0.2, 2.2, 33),
                                            (-1.0, 1.0, 101)])
def test_linspace_bit_exact(start, stop, num):
    want = np.asarray(jnp.linspace(start, stop, num))
    got = tsc.linspace(start, stop, num).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(24, 24), (17, 40)])
def test_camera_rays_bit_exact(hw):
    jo, jd = jsc.camera_rays(jsc.look_at_camera(*hw, theta=0.7, phi=0.5))
    to, td = tsc.camera_rays(tsc.look_at_camera(*hw, theta=0.7, phi=0.5),
                             device="cpu")
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("probe_hw,full_hw,seed", [
    ((12, 12), (48, 48), 0), ((12, 12), (48, 48), 1),
    ((160, 160), (800, 800), 0), ((160, 160), (800, 800), 1)])
def test_interpolate_counts_exact(probe_hw, full_hw, seed):
    """Ladder-valued probe maps snap up through ceil(): one ulp of
    interpolation error at a grid node would move a count a rung."""
    rng = np.random.default_rng(seed)
    probe = rng.choice(LADDER, probe_hw[0] * probe_hw[1]).astype(np.int32)
    want = np.asarray(jad.interpolate_counts(jnp.asarray(probe), probe_hw,
                                             full_hw))
    got = tad.interpolate_counts(torch.from_numpy(probe), probe_hw,
                                 full_hw).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= set(LADDER.tolist())


def test_interpolate_map_exact():
    rng = np.random.default_rng(2)
    probe = rng.uniform(0, 1, 12 * 10).astype(np.float32)
    want = np.asarray(jad.interpolate_map(jnp.asarray(probe), (12, 10), (48, 37)))
    got = tad.interpolate_map(torch.from_numpy(probe), (12, 10), (48, 37)).numpy()
    np.testing.assert_array_equal(got, want)


def _probe_samples(seed=0, R=64, S=96):
    rng = np.random.default_rng(seed)
    sig = np.where(rng.uniform(size=(R, S)) < 0.7, 0.0,
                   rng.exponential(20.0, (R, S))).astype(np.float32)
    sig[: R // 4] = 0.0                                   # background rays
    col = rng.uniform(size=(R, S, 3)).astype(np.float32)
    col[R // 4: R // 2] = col[R // 4: R // 2, :1]         # flat colors
    return sig, col


@pytest.mark.parametrize("delta", [1.0 / 2048.0, 1.0 / 64.0])
def test_probe_counts_exact(delta):
    sig, col = _probe_samples()
    S = sig.shape[1]
    deltas = np.full(sig.shape, (jsc.FAR - jsc.NEAR) / S, np.float32)
    rgb_j, _, _ = jr.composite(jnp.asarray(sig), jnp.asarray(col),
                               jnp.asarray(deltas))
    want = np.asarray(jad.probe_counts(jnp.asarray(sig), jnp.asarray(col),
                                       rgb_j, S, (12, 24, 48), delta))
    rgb_t, _, _ = tr.composite(torch.from_numpy(sig), torch.from_numpy(col),
                               torch.from_numpy(deltas))
    got = tad.probe_counts(torch.from_numpy(sig), torch.from_numpy(col),
                           rgb_t, S, (12, 24, 48), delta).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) >= 2


def test_composite_and_depth_match():
    sig, col = _probe_samples(seed=3)
    S = sig.shape[1]
    deltas = np.full(sig.shape, (jsc.FAR - jsc.NEAR) / S, np.float32)
    ts = np.broadcast_to(np.linspace(0.2, 2.2, S, dtype=np.float32), sig.shape)
    rgb_j, acc_j, w_j = jr.composite(jnp.asarray(sig), jnp.asarray(col),
                                     jnp.asarray(deltas))
    rgb_t, acc_t, w_t = tr.composite(torch.from_numpy(sig), torch.from_numpy(col),
                                     torch.from_numpy(deltas))
    for g, w in ((rgb_t, rgb_j), (acc_t, acc_j), (w_t, w_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    d_j = jr.expected_termination_depth(w_j, jnp.asarray(ts), acc_j, jsc.FAR)
    d_t = tr.expected_termination_depth(w_t, torch.from_numpy(ts.copy()),
                                        acc_t, tsc.FAR)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("block", [16, 64])
def test_sort_rays_into_blocks_stable(block):
    """Many equal counts: only a stable sort reproduces the reference's
    order, and with it the block layout."""
    rng = np.random.default_rng(block)
    counts = rng.choice(LADDER, 256).astype(np.int32)
    o_j, b_j = jad.sort_rays_into_blocks(jnp.asarray(counts), block)
    o_t, b_t = tad.sort_rays_into_blocks(torch.from_numpy(counts), block)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


def test_block_sort_by_opacity_exact():
    rng = np.random.default_rng(5)
    counts = rng.choice(LADDER, 128).astype(np.int32)
    opacity = rng.choice([0.0, 0.25, 0.5, 1.0], 128).astype(np.float32)
    kw = dict(block_size=32, sort_by_opacity=True)
    o_j, b_j = jpl.block_sort(jpl.ASDRConfig(**kw), jnp.asarray(counts),
                              jnp.asarray(opacity))
    o_t, b_t = tpl.block_sort(tpl.ASDRConfig(**kw), torch.from_numpy(counts),
                              torch.from_numpy(opacity))
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


@pytest.mark.parametrize("n,S", [(2, 16), (3, 16), (4, 9)])
def test_interpolate_group_colors(n, S):
    rng = np.random.default_rng(n)
    A = -(-S // n)
    anchors = rng.uniform(size=(5, A, 3)).astype(np.float32)
    want = np.asarray(jdec.interpolate_group_colors(jnp.asarray(anchors), n, S))
    got = tdec.interpolate_group_colors(torch.from_numpy(anchors), n, S).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_compute_savings_matches():
    rng = np.random.default_rng(6)
    counts = rng.choice(LADDER, 400).astype(np.int32)
    want = jad.compute_savings(jnp.asarray(counts), 192)
    got = tad.compute_savings(torch.from_numpy(counts), 192)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6)


def test_pad_rays_to_blocks_matches():
    rng = np.random.default_rng(7)
    o = rng.uniform(size=(50, 3)).astype(np.float32)
    d = rng.uniform(size=(50, 3)).astype(np.float32)
    c = rng.choice(LADDER, 50).astype(np.int32)
    a = jpl.ASDRConfig(block_size=16)
    want = jpl.pad_rays_to_blocks(a, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(c), jnp.asarray(c * 0.0))
    got = tpl.pad_rays_to_blocks(tpl.ASDRConfig(block_size=16),
                                 torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(c),
                                 torch.from_numpy((c * 0.0).astype(np.float32)))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[4] == want[4] == 14
