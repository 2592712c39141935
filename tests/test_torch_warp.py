"""Port parity: the cross-frame reuse helpers of core/adaptive.py and the
reprojection primitive framecache/warp.py against the JAX reference.

Pixel indices, validity masks, count maps, the z-buffer's winners and the
three adaptive helpers are held exactly: ``project_to_camera`` rounds a
float to a pixel, so one ulp moves a splat.  Warped radiance within the
reference contract, rtol 1e-4 / atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import adaptive as jad
from repro.core import fields as jfields
from repro.core import pipeline as jpl
from repro.core import scene as jsc
from repro.framecache import warp as jw
from repro_torch.core import adaptive as tad
from repro_torch.core import fields as tfields
from repro_torch.core import pipeline as tpl
from repro_torch.core import scene as tsc
from repro_torch.framecache import warp as tw

SIZE = 24
ACFG = dict(ns_full=48, probe_stride=4, candidates=(8, 16, 32), block_size=64,
            chunk=16)
RTOL, ATOL = 1e-4, 1e-5


def cams(theta, phi=0.5, size=SIZE):
    return (jsc.look_at_camera(size, size, theta=theta, phi=phi),
            tsc.look_at_camera(size, size, theta=theta, phi=phi))


@pytest.fixture(scope="module")
def depth():
    """The mic scene's Phase-I proxy depth at theta 0.7 through both
    packages (held equal within the contract), as float32 numpy."""
    jcam, tcam = cams(0.7)
    _, _, _, dj = jpl.probe_phase(
        jfields.analytic_field_fns(jsc.make_scene("mic")),
        jpl.ASDRConfig(**ACFG), jcam, return_opacity=True, return_depth=True)
    _, _, _, dt = tpl.probe_phase(
        tfields.analytic_field_fns(tsc.make_scene("mic")),
        tpl.ASDRConfig(**ACFG), tcam, return_opacity=True, return_depth=True,
        device="cpu")
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=ATOL)
    return np.array(dj)


# ----------------------------------------------------- adaptive helpers
@settings(max_examples=12, deadline=None)
@given(st.floats(0.0, 0.2), st.floats(-0.1, 0.1), st.floats(0.9, 1.4))
def test_pose_distance_and_radius_exact(dtheta, dphi, radius):
    ja = jsc.look_at_camera(SIZE, SIZE, theta=0.7, phi=0.5)
    jb = jsc.look_at_camera(SIZE, SIZE, theta=0.7 + dtheta, phi=0.5 + dphi,
                            radius=radius)
    ta = tsc.look_at_camera(SIZE, SIZE, theta=0.7, phi=0.5)
    tb = tsc.look_at_camera(SIZE, SIZE, theta=0.7 + dtheta, phi=0.5 + dphi,
                            radius=radius)
    ang, tr = tad.pose_distance(ta, tb)
    assert (ang, tr) == jad.pose_distance(ja, jb)
    for margin in (1.0, 1.5):
        assert (tad.reuse_dilation_radius(tb, ang, tr, tsc.NEAR, margin)
                == jad.reuse_dilation_radius(jb, ang, tr, jsc.NEAR, margin))


@pytest.mark.parametrize("radius", [0, 1, 2, 4])
@pytest.mark.parametrize("border_fill", [None, 48])
def test_dilate_count_map_exact(radius, border_fill):
    rng = np.random.default_rng(radius)
    H, W = 13, 17
    counts = rng.choice(np.array([8, 16, 32, 48], np.int32), H * W)
    got = tad.dilate_count_map(torch.from_numpy(counts), (H, W), radius,
                               border_fill)
    want = jad.dilate_count_map(jnp.asarray(counts), (H, W), radius,
                                border_fill)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------- warp
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_project_to_camera_exact(seed):
    """Points in front of, beside and behind the camera, some landing
    exactly on pixel centres' half-way lines."""
    rng = np.random.default_rng(seed)
    jcam, tcam = cams(0.9)
    pts = rng.uniform(-0.5, 1.5, (4000, 3)).astype(np.float32)
    pts[:50] = np.asarray(tcam.origin) + rng.uniform(
        -1e-3, 1e-3, (50, 3)).astype(np.float32)
    ti, tok, tdist = tw.project_to_camera(torch.from_numpy(pts), tcam)
    ji, jok, jdist = jw.project_to_camera(jnp.asarray(pts), jcam)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    ok = np.asarray(jok)
    assert 0 < ok.sum() < ok.size
    np.testing.assert_array_equal(ti.numpy()[ok], np.asarray(ji)[ok])
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist))


@pytest.mark.parametrize("dtheta,dphi", [(0.0, 0.0), (0.01, 0.0),
                                         (0.03, 0.02), (-0.05, 0.0)])
def test_forward_warp_exact(depth, dtheta, dphi):
    jsrc, tsrc = cams(0.7)
    jdst, tdst = cams(0.7 + dtheta, 0.5 + dphi)
    got = tw.forward_warp(tsrc, tdst, torch.from_numpy(depth))
    want = jw.forward_warp(jsrc, jdst, jnp.asarray(depth))
    ok = np.asarray(want[1])
    np.testing.assert_array_equal(got[1].numpy(), ok)
    np.testing.assert_array_equal(got[0].numpy()[ok], np.asarray(want[0])[ok])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if dtheta == 0.0 and dphi == 0.0:
        np.testing.assert_array_equal(got[0].numpy(), np.arange(SIZE * SIZE))


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_max_exact(seed):
    """Many sources per target (fold-over), some off the image."""
    rng = np.random.default_rng(seed)
    n, N = 50, 400
    tgt = rng.integers(0, n, N)
    ok = rng.uniform(size=N) < 0.8
    vals = rng.choice(np.array([8, 16, 32, 48], np.int32), N)
    got = tw.scatter_max(torch.from_numpy(vals), torch.from_numpy(tgt),
                         torch.from_numpy(ok), n + 7, fill=0)
    want = jw.scatter_max(jnp.asarray(vals), jnp.asarray(tgt, jnp.int32),
                          jnp.asarray(ok), n + 7, fill=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[1].numpy()[n:].any()


def test_nearest_source_exact_with_ties():
    """Coplanar splats: equal and near-equal distances (within the
    relative 1e-5 + 1e-6 epsilon) on one target, so the lowest source
    index among them must win; a farther source must lose."""
    rng = np.random.default_rng(3)
    n, N = 40, 600
    tgt = rng.integers(0, n, N)
    ok = rng.uniform(size=N) < 0.9
    dist = rng.choice(np.array([1.0, 1.0 + 5e-6, 1.5, 2.0], np.float32), N)
    dist[tgt == 7] = np.float32(1.25)       # exact ties on one target
    got = tw.nearest_source(torch.from_numpy(tgt), torch.from_numpy(ok),
                            torch.from_numpy(dist), n)
    want = jw.nearest_source(jnp.asarray(tgt, jnp.int32), jnp.asarray(ok),
                             jnp.asarray(dist), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][7] == np.flatnonzero((tgt == 7) & ok)[0]


@pytest.mark.parametrize("dtheta,margin", [(0.01, 1), (0.03, 0), (0.03, 2),
                                           (0.0, 1)])
def test_warp_count_map_exact(depth, dtheta, margin):
    jsrc, tsrc = cams(0.7)
    jdst, tdst = cams(0.7 + dtheta)
    counts, _ = jpl.probe_phase(
        jfields.analytic_field_fns(jsc.make_scene("mic")),
        jpl.ASDRConfig(**ACFG), jsrc)
    counts = np.array(counts)
    got = tw.warp_count_map(torch.from_numpy(counts), torch.from_numpy(depth),
                            tsrc, tdst, 48, margin=margin)
    want = jw.warp_count_map(jnp.asarray(counts), jnp.asarray(depth), jsrc,
                             jdst, 48, margin=margin)
    assert got[0].dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtheta,dphi", [(0.0, 0.0), (0.02, 0.0),
                                         (0.04, -0.03)])
def test_warp_image_matches(depth, dtheta, dphi):
    rng = np.random.default_rng(4)
    rgb = rng.uniform(size=(SIZE * SIZE, 3)).astype(np.float32)
    acc = rng.uniform(size=SIZE * SIZE).astype(np.float32)
    jsrc, tsrc = cams(0.7)
    jdst, tdst = cams(0.7 + dtheta, 0.5 + dphi)
    got = tw.warp_image(torch.from_numpy(rgb), torch.from_numpy(acc),
                        torch.from_numpy(depth), tsrc, tdst)
    want = jw.warp_image(jnp.asarray(rgb), jnp.asarray(acc),
                         jnp.asarray(depth), jsrc, jdst)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    if dtheta == 0.0:
        assert got[3].all()
        np.testing.assert_array_equal(got[0].numpy(), rgb)
