"""Port parity: the cross-frame reuse tiers (framecache/) against the JAX
reference's, on the analytic mic scene and a small NGP whose weights are
carried across from JAX.

A 6-pose trajectory through ``render_asdr_image_cached`` of both packages
(all three tiers on): per frame the flags, rays marched, warp valid
fraction, block hits and misses and samples equal, the image within rtol
1e-4 / atol 1e-5; the caches' counters equal at the end.  Probe maps in
each reuse mode: counts exact, opacity and depth within the contract.
"""
import jax
import numpy as np
import pytest
import torch

from repro import framecache as jfc
from repro import scenecache as jsc_
from repro.core import fields as jfields
from repro.core import pipeline as jpl
from repro.core import scene as jsc
from repro.core.model import NGPConfig as JNGPConfig, init_ngp
from repro.core.model import field_fns as j_field_fns
from repro_torch import framecache as tfc
from repro_torch import params as tparams
from repro_torch import scenecache as tsc_
from repro_torch.core import fields as tfields
from repro_torch.core import model as tmodel
from repro_torch.core import pipeline as tpl
from repro_torch.core import scene as tsc
from repro_torch.framecache import base as tbase

ACFG = dict(ns_full=48, probe_stride=4, candidates=(8, 16, 32), block_size=64,
            chunk=16)
SIZE = 24
RTOL, ATOL = 1e-4, 1e-5
TABLE_GAIN = 300.0
STAT_KEYS = ("probe_reused", "probe_skipped", "radiance_reused",
             "rays_marched", "rays_total", "warp_valid_fraction",
             "scene_block_hits", "scene_block_misses", "samples_processed",
             "samples_reused", "probe_samples")


def cams(theta, phi=0.5):
    return (jsc.look_at_camera(SIZE, SIZE, theta=theta, phi=phi),
            tsc.look_at_camera(SIZE, SIZE, theta=theta, phi=phi))


@pytest.fixture(scope="module")
def fields():
    cfg = JNGPConfig.small()
    params = dict(init_ngp(jax.random.PRNGKey(3), cfg))
    params["grid"] = params["grid"] * TABLE_GAIN
    field = tparams.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    return {"mic": (jfields.analytic_field_fns(jsc.make_scene("mic")),
                    tfields.analytic_field_fns(tsc.make_scene("mic"))),
            "ngp": (j_field_fns(params, cfg), tmodel.field_fns(field))}


def both_caches(probe_kw, radiance_kw, scene):
    """The same FrameCache layout in both packages (None = tier off)."""
    out = []
    for fc, sc in ((jfc, jsc_), (tfc, tsc_)):
        out.append(fc.make_frame_cache(
            None if probe_kw is None else fc.ProbeReuseConfig(**probe_kw),
            None if radiance_kw is None
            else fc.RadianceReuseConfig(**radiance_kw),
            sc.SceneBlockCache() if scene else None,
            "mic" if scene else "scene"))
    return out


def cache_counters(fc):
    out = {}
    for name in ("probe", "radiance"):
        c = getattr(fc, name)
        if c is not None:
            out[name] = (c.hits, c.misses, c.refreshes,
                         getattr(c, "skips", None),
                         getattr(c, "low_valid_misses", None), len(c))
    if fc.scene is not None:
        out["scene"] = fc.scene.stats()
    return out


def run_trajectory(fields, name, probe_kw, radiance_kw, scene=True,
                   thetas=tuple(0.7 + 0.01 * k for k in range(6))):
    fj, ft = fields[name]
    jfcache, tfcache = both_caches(probe_kw, radiance_kw, scene)
    acfg_j, acfg_t = jpl.ASDRConfig(**ACFG), tpl.ASDRConfig(**ACFG)
    frames = []
    for th in thetas:
        jcam, tcam = cams(th)
        jimg, jst = jfc.render_asdr_image_cached(fj, acfg_j, jcam, jfcache)
        timg, tst = tfc.render_asdr_image_cached(ft, acfg_t, tcam, tfcache,
                                                 device="cpu")
        for k in STAT_KEYS:
            assert tst[k] == int(jst[k]) if k == "samples_processed" \
                else tst[k] == jst[k], (th, k, tst[k], jst[k])
        np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=RTOL,
                                   atol=ATOL)
        frames.append((timg, tst))
    assert cache_counters(tfcache) == cache_counters(jfcache)
    return frames


@pytest.mark.parametrize("name", ["mic", "ngp"])
@pytest.mark.parametrize("probe_kw,radiance_kw", [
    ({}, {}),
    (dict(refresh_every=2), dict(refresh_every=1, max_entries=2)),
    (dict(warp=False, dilate_cap=64), None),
    (None, dict(min_valid_fraction=0.99))])
def test_trajectory_matches(fields, name, probe_kw, radiance_kw):
    """The 6-pose trajectory, 0.57 deg a step, through every tier in the
    default layout, with refreshes and eviction forced, in dilation mode
    without radiance, and with radiance only (low-valid misses)."""
    frames = run_trajectory(fields, name, probe_kw, radiance_kw)
    if probe_kw == {} and radiance_kw == {}:
        assert [f[1]["radiance_reused"] for f in frames] == [
            False, True, True, True, False, True]


def test_cold_frame_is_render_asdr_image(fields):
    """All tiers cold: the frame and its count map equal
    render_asdr_image's bit for bit; replaying the pose hits every block
    of the scene tier and returns the same frame."""
    _, ft = fields["ngp"]
    acfg = tpl.ASDRConfig(**ACFG)
    _, cam = cams(0.7)
    fc = tfc.make_frame_cache(radiance_cfg=None,
                              scene_cache=tsc_.SceneBlockCache(),
                              scene_id="ngp")
    img, st = tfc.render_asdr_image_cached(ft, acfg, cam, fc, device="cpu")
    ref, st_ref = tpl.render_asdr_image(ft, acfg, cam, device="cpu")
    assert torch.equal(img, ref)
    assert torch.equal(st["counts"], st_ref["counts"])
    img2, st2 = tfc.render_asdr_image_cached(ft, acfg, cam, fc, device="cpu")
    assert torch.equal(img2, ref) and st2["probe_reused"]
    assert st2["scene_block_hits"] == SIZE * SIZE // ACFG["block_size"]


@pytest.mark.parametrize("mode,dtheta,probe_kw", [
    ("exact", 0.0, {}), ("warp", 0.02, {}),
    ("dilate", 0.02, dict(warp=False, dilate_cap=64)),
    ("refresh", 0.02, dict(refresh_every=1))])
def test_probe_maps_match(fields, mode, dtheta, probe_kw):
    fj, ft = fields["mic"]
    acfg_j, acfg_t = jpl.ASDRConfig(**ACFG), tpl.ASDRConfig(**ACFG)
    jc = jfc.ProbeCache(jfc.ProbeReuseConfig(**probe_kw))
    tc = tfc.ProbeCache(tfc.ProbeReuseConfig(**probe_kw))
    poses = (0.7, 0.7 + dtheta) + ((0.7 + 2 * dtheta,) if mode == "refresh"
                                   else ())
    for th in poses:
        jcam, tcam = cams(th)
        jplan = jfc.plan_probe(jc, jcam, acfg_j)
        tplan = tfc.plan_probe(tc, tcam, acfg_t)
        assert (tplan.kind, tplan.mode) == (jplan.kind, jplan.mode)
        jm, jr = jfc.cached_probe_maps(fj, acfg_j, jcam, jc)
        tm, tr = tfc.cached_probe_maps(ft, acfg_t, tcam, tc, device="cpu")
        assert tr == jr and tm.cost == jm.cost
        np.testing.assert_array_equal(tm.counts.numpy(), np.asarray(jm.counts))
        np.testing.assert_allclose(tm.opacity.numpy(), np.asarray(jm.opacity),
                                   rtol=RTOL, atol=ATOL)
        assert (tm.depth is None) == (jm.depth is None)
        if tm.depth is not None:
            np.testing.assert_allclose(tm.depth.numpy(), np.asarray(jm.depth),
                                       rtol=RTOL, atol=ATOL)
    want = {"exact": "reuse", "warp": "reuse", "dilate": "reuse",
            "refresh": "refresh"}[mode]
    assert tplan.kind == want and (want != "reuse" or tplan.mode == mode)
    jcam, tcam = cams(0.7 + 3 * dtheta)
    want = jfc.probe_phase_cached(fj, acfg_j, jcam, jc)
    got = tfc.probe_phase_cached(ft, acfg_t, tcam, tc, device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1:2] + got[3:] == want[1:2] + want[3:]


def test_radiance_replay_is_bit_exact(fields):
    """Replaying a pose returns the cached frame, marching zero rays and
    skipping Phase I; warped frames are never re-cached; refresh_every
    forces a full render."""
    _, ft = fields["mic"]
    acfg = tpl.ASDRConfig(**ACFG)
    _, cam = cams(0.7)
    fc = tfc.make_frame_cache(
        radiance_cfg=tfc.RadianceReuseConfig(refresh_every=2))
    out = [tfc.render_asdr_image_cached(ft, acfg, cam, fc, device="cpu")
           for _ in range(4)]
    assert [o[1]["radiance_reused"] for o in out] == [False, True, True,
                                                      False]
    assert out[1][1]["rays_marched"] == 0 and out[1][1]["probe_skipped"]
    assert torch.equal(out[0][0], out[1][0]) and len(fc.radiance) == 1
    assert fc.radiance.refreshes == 1 and fc.probe.skips == 2


def test_radiance_low_valid_fraction_is_miss(fields):
    _, ft = fields["mic"]
    acfg = tpl.ASDRConfig(**ACFG)
    _, cam = cams(0.7)
    cache = tfc.RadianceCache(tfc.RadianceReuseConfig(
        max_angle_deg=90.0, max_translation=10.0, min_valid_fraction=0.95))
    tfc.render_asdr_image_cached(ft, acfg, cam, tfc.FrameCache(radiance=cache),
                                 device="cpu")
    right = np.asarray(cam.c2w_rot)[:, 0]
    cam_t = tsc.Camera(cam.height, cam.width, cam.focal, cam.c2w_rot,
                       np.asarray(cam.origin) + 0.3 * right)
    plan = tfc.plan_lookup(cache, cam_t, acfg)
    assert plan.kind == "miss" and plan.reason == "low_valid"
    assert cache.lookup(cam_t, acfg) is None and cache.low_valid_misses == 1


def test_pose_cache_eviction_and_bytes():
    """LRU ties break by insertion order; resident bytes count the maps."""
    class _E:
        last_used = 0

    cache = tbase.PoseKeyedCache(tfc.ProbeReuseConfig(max_entries=2))
    e1, e2, e3 = _E(), _E(), _E()
    cache._append_with_eviction(e1)
    cache._append_with_eviction(e2)
    cache._append_with_eviction(e3)
    assert e1 not in cache._entries and [e.seq for e in cache._entries] == [
        1, 2]
    R = SIZE * SIZE
    probe = tfc.ProbeCache()
    probe._store(cams(0.7)[1], tpl.ASDRConfig(**ACFG), tfc.ProbeMaps(
        torch.zeros(R, dtype=torch.int32), torch.zeros(R), None, 0))
    assert probe.resident_bytes() == 2 * 4 * R


def test_pipeline_reexports_are_framecache():
    assert tpl.ProbeCache is tfc.ProbeCache
    assert tpl.ProbeReuseConfig is tfc.ProbeReuseConfig
    assert tpl.probe_phase_cached is tfc.probe_phase_cached
    with pytest.raises(AttributeError):
        tpl.NoSuchThing  # noqa: B018
