"""Port parity: the fused field (density chain, then color chain, in one
kernel) — the wrapper's CPU path, its plain version — against the JAX
``ops.fused_field`` (Pallas in interpret mode)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.model import NGPConfig as JNGPConfig, init_ngp
from repro.kernels import ops as jops
from repro_torch import params as tparams
from repro_torch.configs import ingp_asdr
from repro_torch.core import mlp as tmlp
from repro_torch.kernels import fused_mlp as tfm
from repro_torch.kernels import ops as tops

# the port's float32 contract: its dense layers sum in another order than XLA's
RTOL, ATOL = 1e-4, 1e-5


def _field(paper_mlp):
    cfg = JNGPConfig.small(paper_mlp=paper_mlp)
    params = init_ngp(jax.random.PRNGKey(1), cfg)
    field = tparams.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    return cfg, params, field


def _inputs(cfg, n, seed):
    rng = np.random.default_rng(seed)
    enc = (rng.normal(size=(n, cfg.net.encoding_dim)) * 0.3).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return enc, dirs


@pytest.mark.parametrize("n", [3, 128, 300])
@pytest.mark.parametrize("paper_mlp", [False, True])
def test_fused_field_matches_pallas(n, paper_mlp):
    cfg, params, field = _field(paper_mlp)
    enc, dirs = _inputs(cfg, n, seed=n)
    want = jops.fused_field(jnp.asarray(enc), jnp.asarray(dirs), params["mlps"],
                            cfg.net)
    got = tops.fused_field(torch.from_numpy(enc), torch.from_numpy(dirs),
                           tops.FusedMarchResources(field), field.cfg.net)
    for name, g, w in zip(("sigma", "rgb", "geo"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_fused_field_takes_packed_chains():
    """The (flat, dims) pairs give what the field's resources give."""
    cfg, _, field = _field(True)
    enc, dirs = _inputs(cfg, 40, seed=7)
    res = tops.FusedMarchResources(field)
    e, d = torch.from_numpy(enc), torch.from_numpy(dirs)
    for a, b in zip(tops.fused_field(e, d, res, field.cfg.net),
                    tops.fused_field(e, d, (res.density, res.color),
                                     field.cfg.net)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("paper_mlp", [False, True])
def test_fused_field_plain_is_the_kernel_pair(paper_mlp):
    """The fused plain version equals the density -> color plain pair bit
    for bit, as the kernel must equal the density -> color kernel pair."""
    cfg, _, field = _field(paper_mlp)
    enc, dirs = _inputs(cfg, 64, seed=11)
    res = tops.FusedMarchResources(field)
    e = torch.from_numpy(enc)
    sh = tmlp.sh_encode(torch.from_numpy(dirs), cfg.net.sh_degree)
    packed = tfm.fused_field(e, sh, *res.density, *res.color)
    dout = tfm.density_mlp(e, *res.density)
    rgb = tfm.color_mlp(torch.cat([dout[:, 1:], sh], 1), *res.color)
    assert packed.shape == (64, 4 + cfg.net.geo_feature_dim)
    assert torch.equal(packed[:, :1], dout[:, :1])
    assert torch.equal(packed[:, 1:4], rgb)
    assert torch.equal(packed[:, 4:], dout[:, 1:])


PAPER_DENSITY = (32, 64, 16)
PAPER_COLOR = (31, 128, 128, 128, 3)


def test_tile_kernels_shared_memory_at_the_paper_widths():
    """Weights + k-major activations of a 64-row tile + two input tiles:
    148,480 + 32,768 + 15,872 B for color, 160,768 + 32,768 + 24,576 B for
    the fused field, both within one CTA's 232,448 B."""
    assert tfm.TILE_ROWS == 64
    assert tfm.color_smem_bytes(PAPER_COLOR) == 197_120
    assert tfm.fused_smem_bytes(PAPER_DENSITY, PAPER_COLOR) == 218_112
    assert max(197_120, 218_112) <= tfm.SMEM_LIMIT
    tfm.check_color_chain(PAPER_COLOR)
    tfm.check_fused_chains(PAPER_DENSITY, PAPER_COLOR)


def test_density_kernel_shared_memory_at_the_paper_widths():
    """Weights 12,288 B, the k-major activations of a 64-row tile 16,384 B,
    two input tiles 16,384 B and the staging tile of 64 output rows of 17
    floats 4,352 B."""
    assert tfm.density_smem_bytes(PAPER_DENSITY) == 49_408
    assert 12_288 + 16_384 + 16_384 + 4_352 == 49_408
    tfm.check_density_chain(PAPER_DENSITY)


OVER_WIDE_DENSITY = (32,) + (128,) * 7 + (16,)       # 104,448 floats


@pytest.mark.parametrize("dims, match", [
    ((32, 62, 16), "multiples of 4"), ((32, 100, 16), "of 8 above 64"),
    (OVER_WIDE_DENSITY, "shared memory")], ids=["fours", "eights", "wide"])
def test_density_mlp_refuses_before_launch(dims, match):
    """Off the CPU the density wrapper checks the chain before it builds
    or launches anything."""
    meta = torch.device("meta")
    enc = torch.empty((8, dims[0]), device=meta)
    w = torch.empty((tfm.chain_size(dims),), device=meta)
    with pytest.raises(ValueError, match=match):
        tfm.density_mlp(enc, w, dims)


def test_paper_config_chains_are_the_paper_widths():
    net = ingp_asdr.CONFIG.model.net
    assert tuple(net.density_sizes()) == PAPER_DENSITY
    assert tuple(net.color_sizes()) == PAPER_COLOR


OVER_WIDE_COLOR = (31,) + (128,) * 7 + (3,)          # 114,688 floats of weights
OVER_WIDE_FUSED = (PAPER_DENSITY, (31, 128, 128, 128, 128, 3))


@pytest.mark.parametrize("chains", [(None, OVER_WIDE_COLOR), OVER_WIDE_FUSED],
                         ids=["color", "fused"])
def test_over_wide_chains_raise(chains):
    dims_d, dims_c = chains
    with pytest.raises(ValueError, match="shared memory"):
        if dims_d is None:
            tfm.check_color_chain(dims_c)
        else:
            tfm.check_fused_chains(dims_d, dims_c)


def test_wrappers_refuse_over_wide_chains_before_launch():
    """Off the CPU the wrappers check the chain before they build or
    launch anything (meta tensors carry the shapes, no data)."""
    dims_d, dims_c = OVER_WIDE_FUSED
    n, meta = 8, torch.device("meta")
    enc = torch.empty((n, dims_d[0]), device=meta)
    sh = torch.empty((n, dims_c[0] - dims_d[-1] + 1), device=meta)
    wd = torch.empty((tfm.chain_size(dims_d),), device=meta)
    wc = torch.empty((tfm.chain_size(dims_c),), device=meta)
    with pytest.raises(ValueError, match="shared memory"):
        tfm.fused_field(enc, sh, wd, dims_d, wc, dims_c)
    cin = torch.empty((n, OVER_WIDE_COLOR[0]), device=meta)
    w = torch.empty((tfm.chain_size(OVER_WIDE_COLOR),), device=meta)
    with pytest.raises(ValueError, match="shared memory"):
        tfm.color_mlp(cin, w, OVER_WIDE_COLOR)


def test_tile_kernels_need_hidden_widths_in_fours():
    with pytest.raises(ValueError, match="multiples of 4"):
        tfm.check_color_chain((31, 126, 3))
    with pytest.raises(ValueError, match="multiples of 4"):
        tfm.check_fused_chains((32, 62, 16), PAPER_COLOR)
    with pytest.raises(ValueError, match="of 8 above 64"):
        tfm.check_color_chain((31, 100, 3))
    tfm.check_color_chain((31, 60, 3))       # the last width may be any
    tfm.check_color_chain((31, 96, 5))


@pytest.mark.parametrize("paper_mlp", [False, True])
def test_fused_field_plain_color_rounds_once_per_mac(paper_mlp):
    """The fused plain version's rgb is the fma chain on [geo, sh]; its
    sigma and geo are the density chain's (product and sum rounded apart)."""
    cfg, _, field = _field(paper_mlp)
    enc, dirs = _inputs(cfg, 50, seed=13)
    res = tops.FusedMarchResources(field)
    e = torch.from_numpy(enc)
    sh = tmlp.sh_encode(torch.from_numpy(dirs), cfg.net.sh_degree)
    packed = tfm.fused_field_plain(e, sh, *res.density, *res.color)
    dout = tfm.chain_plain(e, *res.density)
    cin = torch.cat([dout[:, 1:], sh], 1)
    rgb = tfm.sigmoid_plain(tfm.chain_plain(cin, *res.color,
                                            dense=tfm.dense_plain_fma))
    assert torch.equal(packed[:, 1:4], rgb)
    assert torch.equal(packed[:, 4:], dout[:, 1:])
    assert torch.equal(packed[:, :1], tfm.trunc_exp_plain(dout[:, :1]))
