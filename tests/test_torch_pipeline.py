"""Port parity: the two-phase frame (render_asdr_image) against the JAX
reference on the analytic scenes (test_torch_frame.py renders an NGP whose
weights are carried across from JAX).  Count maps, budgets and chunk
counters exactly equal; the image within rtol 1e-4 / atol 1e-5 and its
PSNR against the fixed-count render within 0.1 dB."""
import jax
import numpy as np
import pytest
import torch

from repro.core import fields as jfields
from repro.core import pipeline as jpl
from repro.core import rendering as jr
from repro.core import scene as jsc
from repro_torch.core import fields as tfields
from repro_torch.core import pipeline as tpl
from repro_torch.core import rendering as tr
from repro_torch.core import scene as tsc

HW = (32, 32)
CAM = dict(theta=0.7, phi=0.5)


def check_frame(jimg, jst, timg, tst, jref, tref):
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=1e-4,
                               atol=1e-5)
    for k in ("budgets", "chunks_per_block", "ray_chunks_per_block"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]),
                                      err_msg=k)
    assert tst["samples_processed"] == int(jst["samples_processed"])
    p_j = float(jr.psnr(jimg, jref))
    p_t = float(tr.psnr(timg, tref))
    assert abs(p_j - p_t) <= 0.1, (p_j, p_t)


def fixed_refs(fns_j, fns_t, ns):
    """Both frameworks' fixed-``ns`` render of the view, checked alike."""
    jo, jd = jsc.camera_rays(jsc.look_at_camera(*HW, **CAM))
    to, td = tsc.camera_rays(tsc.look_at_camera(*HW, **CAM), device="cpu")
    jref = jpl.render_fixed_fns(fns_j, jo, jd, ns)[0].reshape(*HW, 3)
    tref = tpl.render_fixed_fns(fns_t, to, td, ns)[0].reshape(*HW, 3)
    np.testing.assert_allclose(tref.numpy(), np.asarray(jref), rtol=1e-4,
                               atol=1e-5)
    return jref, tref


def render_both(fns_j, fns_t, acfg_kw, refs=None, counts=True):
    """Both frameworks' ASDR frame of the view; with ``counts`` the count
    maps are held exactly (the reference's from its own probe_phase)."""
    jcam = jsc.look_at_camera(*HW, **CAM)
    tcam = tsc.look_at_camera(*HW, **CAM)
    jimg, jst = jpl.render_asdr_image(fns_j, jpl.ASDRConfig(**acfg_kw), jcam)
    timg, tst = tpl.render_asdr_image(fns_t, tpl.ASDRConfig(**acfg_kw), tcam,
                                      device="cpu")
    if counts:
        counts_j, _ = jpl.probe_phase(fns_j, jpl.ASDRConfig(**acfg_kw), jcam)
        np.testing.assert_array_equal(tst["counts"].numpy(),
                                      np.asarray(counts_j))
    jref, tref = refs or fixed_refs(fns_j, fns_t, acfg_kw["ns_full"])
    return jimg, jst, timg, tst, jref, tref


@pytest.mark.parametrize("scene_name", ["mic", "lego"])
def test_analytic_frame_matches(scene_name):
    fns_j = jfields.analytic_field_fns(jsc.make_scene(scene_name))
    fns_t = tfields.analytic_field_fns(tsc.make_scene(scene_name))
    kw = dict(ns_full=96, probe_stride=4, block_size=64, chunk=16,
              candidates=(12, 24, 48))
    out = render_both(fns_j, fns_t, kw)
    check_frame(*out)
    assert len(np.unique(out[3]["counts"].numpy())) >= 2


def test_sort_by_opacity_frame_matches():
    fns_j = jfields.analytic_field_fns(jsc.make_scene("hotdog"))
    fns_t = tfields.analytic_field_fns(tsc.make_scene("hotdog"))
    kw = dict(ns_full=96, probe_stride=4, block_size=64, chunk=16,
              candidates=(12, 24, 48), sort_by_opacity=True)
    check_frame(*render_both(fns_j, fns_t, kw))


def test_stratified_jitter_matches():
    """Both frameworks fed the same uniform draws give the same samples."""
    u = np.random.default_rng(0).uniform(size=(6, 16)).astype(np.float32)
    jo, jd = jsc.camera_rays(jsc.look_at_camera(2, 3, **CAM))
    to, td = tsc.camera_rays(tsc.look_at_camera(2, 3, **CAM), device="cpu")
    key = jax.random.PRNGKey(0)
    jax_u = np.asarray(jax.random.uniform(key, (6, 16)))
    jpts, _, jts = jsc.sample_points(jo, jd, 16, key)
    tpts, _, tts = tsc.sample_points(to, td, 16, torch.tensor(jax_u))
    np.testing.assert_allclose(tts.numpy(), np.asarray(jts), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), rtol=1e-6,
                               atol=1e-7)
    _, _, ts_u = tsc.sample_points(to, td, 16, torch.from_numpy(u))
    assert not torch.equal(ts_u, tts)


def test_render_reference_matches():
    jo, jd = jsc.camera_rays(jsc.look_at_camera(12, 12, **CAM))
    to, td = tsc.camera_rays(tsc.look_at_camera(12, 12, **CAM), device="cpu")
    want = jsc.render_reference(jsc.make_scene("lego"), jo, jd, 128)
    got = tsc.render_reference(tsc.make_scene("lego"), to, td, 128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
