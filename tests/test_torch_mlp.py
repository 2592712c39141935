"""Port parity: SH encoding, density and color MLPs (plain torch and the
kernel wrappers' CPU paths) against the JAX reference and its Pallas
kernels (interpret)."""
from fractions import Fraction

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


def _exact_fma(a, b, c):
    """fmaf(a, b, c) from rationals: the exact a*b + c rounded to the
    nearest float32, ties to even."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(x))        # at most one ulp off (double rounding)
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.float32(v).view(np.uint32)) & 1))


def _fp32(rng, n, lo, hi):
    m = rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
    return (m * 2.0 ** rng.integers(lo, hi, n)).astype(np.float32)


def _triples(kind, n=1500):
    rng = np.random.default_rng({"wide": 5, "cancel": 6, "midpoint": 7}[kind])
    if kind == "wide":              # exponents over 2^-60 .. 2^60
        return _fp32(rng, n, -30, 30), _fp32(rng, n, -30, 30), _fp32(rng, n, -60, 60)
    if kind == "cancel":            # c close to -a*b: heavy cancellation
        a, b = _fp32(rng, n, -20, 20), _fp32(rng, n, -20, 20)
        c = (-(a.astype(np.float64) * b) * rng.uniform(0.999, 1.001, n))
        return a, b, c.astype(np.float32)
    # a*b within a few ulps of half an ulp of c: the sum lands next to a
    # float32 midpoint, where rounding twice goes wrong
    c = _fp32(rng, n, -10, 10)
    half_ulp = np.spacing(np.abs(c)).astype(np.float64) / 2
    a = (1.0 + rng.integers(-4, 5, n) * 2.0 ** -23).astype(np.float32)
    b = (rng.choice([-1.0, 1.0], n) * half_ulp
         * (1.0 + rng.integers(-4, 5, n) * 2.0 ** -23)).astype(np.float32)
    return a, b, c


@pytest.mark.parametrize("kind", ["wide", "cancel", "midpoint"])
def test_fma_plain_is_the_exact_fma(kind):
    a, b, c = _triples(kind)
    got = tfm.fma_plain(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(c)).numpy()
    want = np.array([_exact_fma(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("b_sign", [1.0, -1.0])
@pytest.mark.parametrize("c", [1 + 2 ** -23, 1 + 3 * 2 ** -23])
def test_fma_plain_rounds_once_where_fp64_rounds_twice(b_sign, c):
    """a*b + c with a = 1+2^-23, b = +-(1-2^-23)*2^-24 lies 2^-70 off a
    float32 midpoint: the float64 sum lands on the midpoint, and rounding
    it again picks the wrong side."""
    a = np.float32(1 + 2 ** -23)
    b = np.float32(b_sign * (1 - 2 ** -23) * 2 ** -24)
    c = np.float32(c)
    want = _exact_fma(a, b, c)
    naive = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    assert naive != want
    got = tfm.fma_plain(torch.tensor([a]), torch.tensor([b]),
                        torch.tensor([c])).item()
    assert np.float32(got) == want


def _dense_exact(x, w):
    y = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k in range(w.shape[0]):
        y = np.array([[_exact_fma(x[i, k], w[k, j], y[i, j])
                       for j in range(w.shape[1])] for i in range(x.shape[0])],
                     np.float32)
    return y


def _dense_case(kind):
    rng = np.random.default_rng({"normal": 8, "midpoints": 9, "tiny": 10}[kind])
    if kind == "normal":
        return (rng.normal(size=(6, 5)).astype(np.float32),
                rng.normal(size=(5, 3)).astype(np.float32))
    if kind == "midpoints":
        # y = c in [1, 2) after k = 0, then a*b within a few ulps of half
        # an ulp of c: many sums land on a float32 midpoint
        x = np.stack([rng.uniform(1.0, 2.0, 40),
                      1.0 + rng.integers(-4, 5, 40) * 2.0 ** -23], 1)
        w = np.stack([np.ones(6), rng.choice([-1.0, 1.0], 6) * 2.0 ** -24
                      * (1.0 + rng.integers(-4, 5, 6) * 2.0 ** -23)])
        return x.astype(np.float32), w.astype(np.float32)
    # exponents near 2^-70: partial sums fall into the subnormal range
    return _fp32(rng, 8, -72, -66).reshape(8, 1) * np.ones((1, 3), np.float32), \
        _fp32(rng, 9, -72, -66).reshape(3, 3)


@pytest.mark.parametrize("kind", ["normal", "midpoints", "tiny"])
def test_dense_plain_fma_sums_in_order(kind):
    """y = fmaf(x[:, k], w[k], y) for k = 0, 1, ... from y = 0, exactly:
    ordinary inputs, sums on float32 midpoints (the rows the fast path
    redoes) and sums in the subnormal range (the exact path)."""
    x, w = _dense_case(kind)
    want = _dense_exact(x, w)
    if kind == "midpoints":     # rounding the float64 sum again goes wrong
        naive = (x[:, :1].astype(np.float64) * w[0]).astype(np.float32)
        naive = (naive + x[:, 1:2].astype(np.float64) * w[1]).astype(np.float32)
        assert (naive != want).any()
    got = tfm.dense_plain_fma(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    blocks = tfm.dense_plain_fma(torch.from_numpy(x), torch.from_numpy(w),
                                 rows=3).numpy()
    np.testing.assert_array_equal(blocks.view(np.uint32), want.view(np.uint32))


def test_color_mlp_plain_is_the_fma_chain(model):
    """The color kernel's plain version: dense_plain_fma per layer, ReLU
    between, a sigmoid after; its CPU wrapper is that plain version."""
    cfg, _, field = model
    _, geo, dirs = _inputs(cfg, seed=9)
    flat, dims = tops.FusedMarchResources(field).color
    cin = torch.cat([torch.from_numpy(geo),
                     tmlp.sh_encode(torch.from_numpy(dirs), cfg.net.sh_degree)], 1)
    h = cin
    for i, w in enumerate(tfm.unpack_chain(flat, dims)):
        h = tfm.dense_plain_fma(h, w)
        if i < len(dims) - 2:
            h = torch.relu(h)
    want = tfm.sigmoid_plain(h)
    assert torch.equal(tfm.color_mlp_plain(cin, flat, dims), want)
    assert torch.equal(tfm.color_mlp(cin, flat, dims), want)
