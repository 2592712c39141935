"""Port parity: the two-phase frame of an NGP whose weights are carried
across from JAX, through the kernel-backed field with both Phase-II
backends and through the plain-torch field (test_torch_pipeline.py holds
the analytic scenes and the shared checks)."""
import jax
import numpy as np
import pytest

from repro.core import pipeline as jpl
from repro.core import scene as jsc
from repro.core import model as jmodel
from repro.core.model import NGPConfig as JNGPConfig, init_ngp
from repro.core.model import field_fns as j_field_fns
from repro.kernels import ops as jops
from repro_torch import params as tparams
from repro_torch.core import model as tmodel
from repro_torch.core import pipeline as tpl
from repro_torch.core import scene as tsc
from repro_torch.kernels import ops as tops
from test_torch_pipeline import CAM, HW, check_frame, fixed_refs, render_both

# tables x 300 give the small NGP a count map over three ladder rungs
TABLE_GAIN = 300.0
ACFG = dict(ns_full=64, probe_stride=4, block_size=256, chunk=16,
            candidates=(8, 16, 32))


@pytest.fixture(scope="module")
def ngp():
    cfg = JNGPConfig.small(paper_mlp=True)
    params = dict(init_ngp(jax.random.PRNGKey(3), cfg))
    params["grid"] = params["grid"] * TABLE_GAIN
    field = tparams.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    refs = fixed_refs(j_field_fns(params, cfg), tmodel.field_fns(field),
                      ACFG["ns_full"])
    return cfg, params, field, refs


def test_plain_field_frame_matches(ngp):
    cfg, params, field, refs = ngp
    out = render_both(j_field_fns(params, cfg), tmodel.field_fns(field),
                      ACFG, refs)
    check_frame(*out)
    assert len(np.unique(out[3]["counts"].numpy())) >= 2


@pytest.mark.parametrize("backend", ["fused", "reference"])
def test_kernel_field_frame_matches(ngp, backend):
    """The kernel-backed field (its CPU path: the kernels' plain versions)
    against the JAX kernel field (Pallas in interpret mode)."""
    cfg, params, field, refs = ngp
    check_frame(*render_both(jops.field_fns(params, cfg), tops.field_fns(field),
                             dict(ACFG, march_backend=backend), refs,
                             counts=False))


def test_probe_phase_opacity_and_depth(ngp):
    cfg, params, field, _ = ngp
    kw = dict(ns_full=64, probe_stride=4, candidates=(8, 16, 32))
    jout = jpl.probe_phase(j_field_fns(params, cfg), jpl.ASDRConfig(**kw),
                           jsc.look_at_camera(*HW, **CAM), return_depth=True)
    tout = tpl.probe_phase(tmodel.field_fns(field), tpl.ASDRConfig(**kw),
                           tsc.look_at_camera(*HW, **CAM), return_depth=True,
                           device="cpu")
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    assert tout[1] == jout[1]
    for g, w in zip(tout[2:], jout[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)




def test_render_fixed_matches(ngp):
    cfg, params, field, _ = ngp
    jo, jd = jsc.camera_rays(jsc.look_at_camera(6, 6, **CAM))
    to, td = tsc.camera_rays(tsc.look_at_camera(6, 6, **CAM), device="cpu")
    want, waux = jmodel.render_fixed(params, cfg, jo, jd, 48)
    got, gaux = tmodel.render_fixed(field, to, td, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gaux["sigmas"].numpy(),
                               np.asarray(waux["sigmas"]), rtol=1e-4, atol=1e-5)
