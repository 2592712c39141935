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
