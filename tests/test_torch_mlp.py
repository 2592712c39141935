"""Port parity: SH encoding, density and color MLPs (plain torch and the
kernel wrappers' CPU paths) against the JAX reference and its Pallas
kernels (interpret)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mlp as jmlp
from repro.core.model import NGPConfig as JNGPConfig, init_ngp
from repro.kernels import ops as jops
from repro_torch import params as tparams
from repro_torch.core import mlp as tmlp
from repro_torch.kernels import fused_mlp as tfm
from repro_torch.kernels import ops as tops

# the port's float32 contract: matmuls sum in another order than XLA's
RTOL, ATOL = 1e-4, 1e-5
N = 96


@pytest.fixture(scope="module", params=[False, True], ids=["small", "paper_mlp"])
def model(request):
    cfg = JNGPConfig.small(paper_mlp=request.param)
    params = init_ngp(jax.random.PRNGKey(2), cfg)
    field = tparams.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    return cfg, params, field


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    enc = rng.normal(0.0, 0.5, (N, cfg.net.encoding_dim)).astype(np.float32)
    geo = rng.normal(0.0, 1.0, (N, cfg.net.geo_feature_dim)).astype(np.float32)
    dirs = rng.normal(size=(N, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return enc, geo, dirs


def test_sh_encode_matches_reference():
    _, _, dirs = _inputs(JNGPConfig.small())
    want = np.asarray(jmlp.sh_encode(jnp.asarray(dirs)))
    got = tmlp.sh_encode(torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_density_apply_matches_reference(model):
    cfg, params, field = model
    enc, _, _ = _inputs(cfg)
    s_j, g_j = jmlp.density_apply(params["mlps"], jnp.asarray(enc))
    s_t, g_t = tmlp.density_apply(field.params()["mlps"], torch.from_numpy(enc))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=RTOL, atol=ATOL)


def test_color_apply_matches_reference(model):
    cfg, params, field = model
    _, geo, dirs = _inputs(cfg, seed=1)
    want = jmlp.color_apply(params["mlps"], jnp.asarray(geo), jnp.asarray(dirs))
    got = tmlp.color_apply(field.params()["mlps"], torch.from_numpy(geo),
                           torch.from_numpy(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_density_kernel_plain_matches_pallas(model):
    cfg, params, field = model
    enc, _, _ = _inputs(cfg, seed=2)
    s_j, g_j = jops.density_mlp(jnp.asarray(enc), params["mlps"], cfg.net)
    res = tops.FusedMarchResources(field)
    s_t, g_t = tops.density_mlp(torch.from_numpy(enc), res.density, field.cfg.net)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=RTOL, atol=ATOL)


def test_color_kernel_plain_matches_pallas(model):
    cfg, params, field = model
    _, geo, dirs = _inputs(cfg, seed=3)
    want = jops.color_mlp(jnp.asarray(geo), jnp.asarray(dirs), params["mlps"],
                          cfg.net)
    res = tops.FusedMarchResources(field)
    got = tops.color_mlp(torch.from_numpy(geo), torch.from_numpy(dirs),
                         res.color, field.cfg.net)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_pack_chain_round_trip(model):
    _, _, field = model
    flat, dims = tfm.pack_chain(field.color_weights)
    assert dims == tuple([field.color_weights[0].shape[0]]
                         + [w.shape[1] for w in field.color_weights])
    for a, b in zip(tfm.unpack_chain(flat, dims), field.color_weights):
        assert torch.equal(a, b)


def test_dense_plain_sums_in_order():
    """The kernel's dense layer adds products k = 0, 1, ... one by one; its
    plain version must round exactly so (not as a matmul would)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(7, 5)).astype(np.float32)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    want = np.zeros((7, 3), np.float32)
    for k in range(5):
        want = want + x[:, k:k + 1] * w[k]
    got = tfm.dense_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
