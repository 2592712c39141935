"""Port parity: the §4.3 decoupled renderer and its strawman, the analytic
FLOP saving, SSIM and the early-termination counts against the JAX
reference, on the small NGP (plain and kernel-backed fields)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decouple as jdec
from repro.core import rendering as jr
from repro.core import scene as jsc
from repro.core.model import NGPConfig as JNGPConfig, init_ngp
from repro.core.model import field_fns as j_field_fns
from repro.kernels import ops as jops
from repro_torch import params as tparams
from repro_torch.core import decouple as tdec
from repro_torch.core import model as tmodel
from repro_torch.core import rendering as tr
from repro_torch.core import scene as tsc
from repro_torch.kernels import ops as tops

RTOL, ATOL = 1e-4, 1e-5
HW = (6, 6)
CAM = dict(theta=0.7, phi=0.5)
# tables x 300 give the small NGP opaque and empty rays alike
TABLE_GAIN = 300.0


@pytest.fixture(scope="module")
def ngp():
    cfg = JNGPConfig.small(paper_mlp=True)
    params = dict(init_ngp(jax.random.PRNGKey(3), cfg))
    params["grid"] = params["grid"] * TABLE_GAIN
    field = tparams.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    jo, jd = jsc.camera_rays(jsc.look_at_camera(*HW, **CAM))
    to, td = tsc.camera_rays(tsc.look_at_camera(*HW, **CAM), device="cpu")
    return cfg, params, field, (jo, jd), (to, td)


def _fns(kind, params, cfg, field):
    if kind == "plain":
        return j_field_fns(params, cfg), tmodel.field_fns(field)
    return jops.field_fns(params, cfg), tops.field_fns(field)


@pytest.mark.parametrize("kind", ["plain", "kernel"])
@pytest.mark.parametrize("group,ns,stratified", [(2, 48, False), (3, 40, True)])
def test_render_decoupled_matches(ngp, kind, group, ns, stratified):
    cfg, params, field, (jo, jd), (to, td) = ngp
    fns_j, fns_t = _fns(kind, params, cfg, field)
    key = jax.random.PRNGKey(ns) if stratified else None
    jitter = (torch.from_numpy(np.array(jax.random.uniform(key, (to.shape[0], ns))))
              if stratified else None)
    rgb_j, st_j = jdec.render_decoupled(fns_j, jo, jd, ns, group=group, key=key)
    rgb_t, st_t = tdec.render_decoupled(fns_t, to, td, ns, group=group,
                                        jitter=jitter)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=RTOL,
                               atol=ATOL)
    assert st_t == st_j


def test_render_naive_reduced_matches(ngp):
    cfg, params, field, (jo, jd), (to, td) = ngp
    fns_j, fns_t = _fns("plain", params, cfg, field)
    want = jdec.render_naive_reduced(fns_j, jo, jd, 48, factor=2)
    got = tdec.render_naive_reduced(fns_t, to, td, 48, factor=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_kept_samples_render_through_volume_render(ngp):
    """The samples ``keep_samples`` returns, composited by ops.volume_render
    (the decoupled kernel's CPU path), give render_decoupled's image."""
    cfg, params, field, _, (to, td) = ngp
    _, fns_t = _fns("kernel", params, cfg, field)
    rgb, st = tdec.render_decoupled(fns_t, to, td, 48, group=2,
                                    keep_samples=True)
    assert st["anchor_colors"].shape == (to.shape[0], 24, 3)
    vr_rgb, _ = tops.volume_render(st["sigmas"], st["anchor_colors"],
                                   st["deltas"], 2)
    np.testing.assert_allclose(vr_rgb.numpy(), rgb.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("paper_mlp,ns,group", [(True, 192, 2), (False, 64, 3)])
def test_mlp_flops_saved_matches(paper_mlp, ns, group):
    jcfg = JNGPConfig.make(paper_mlp=paper_mlp)
    want = jdec.mlp_flops_saved(jcfg, ns, group)
    got = tdec.mlp_flops_saved(tmodel.NGPConfig.make(paper_mlp=paper_mlp), ns,
                               group)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-12), k


def test_ssim_matches():
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(20, 27, 3)).astype(np.float32)
    ref = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(np.float32)
    for a, b in ((img, ref), (img, img)):
        want = float(jr.ssim(jnp.asarray(a), jnp.asarray(b)))
        got = float(tr.ssim(torch.from_numpy(a), torch.from_numpy(b)))
        assert got == pytest.approx(want, rel=1e-5, abs=1e-6)


def test_early_termination_counts_match():
    rng = np.random.default_rng(6)
    alphas = (rng.uniform(size=(16, 64)) ** 4).astype(np.float32)
    alphas[3] = 0.0
    alphas[5, 10:] = 1.0
    want = np.asarray(jr.early_termination_counts(jnp.asarray(alphas)))
    got = tr.early_termination_counts(torch.from_numpy(alphas)).numpy()
    np.testing.assert_array_equal(got, want)
