"""The fused march rebuilt on the register-tiled chain: its plain version's
rounding, its shared-memory reckoning and the shapes its wrapper refuses.

The color chain of the march rounds once per multiply-add, as the color
MLP does: the plain march's anchor colors are ``color_mlp_plain`` of the
[geo, SH] rows of its anchor samples, bit for bit.  The density chain
keeps its separate rounding, so the chunk counters, acc and depth do not
move with the color chain's rounding at all.  (The JAX parity of the
march, at its tolerances, is in test_torch_march*.py.)
"""
import numpy as np
import pytest
import torch

from repro_torch import params as tparams
from repro_torch.core import mlp as tmlp
from repro_torch.core import scene as tscene
from repro_torch.core.model import NGPConfig
from repro_torch.kernels import fused_march as FMA
from repro_torch.kernels import fused_mlp as FM
from repro_torch.kernels import hash_encode as HE
from repro_torch.kernels import ops

PAPER_DENSITY = (32, 64, 16)
PAPER_COLOR = (31, 128, 128, 128, 3)

# name -> (blocks, rays a block, chunk, group, budgets, per_ray_exit)
CASES = {
    "budget_below_chunk": (1, 32, 16, 2, [12], False),
    "group3": (2, 32, 16, 3, [32, 21], False),
    "ragged_block": (3, 24, 16, 2, [16, 48, 33], True),
    "chunk64": (2, 32, 64, 2, [100, 40], False),
}


def _march_inputs(name, table_scale=3.0):
    nb, B, C, group, budgets, per_ray = CASES[name]
    cfg = NGPConfig.small(paper_mlp=True)
    field = tparams.from_jax_params(tparams.random_params(cfg, 5, table_scale),
                                    cfg, device="cpu")
    res = ops.FusedMarchResources(field)
    cam = tscene.look_at_camera(nb * B // 8, 8, theta=0.6, phi=0.4)
    o, d = tscene.camera_rays(cam, device="cpu")
    sh = tmlp.sh_encode(d, cfg.net.sh_degree).contiguous()
    args = (o.contiguous(), d.contiguous(), sh,
            torch.tensor(budgets, dtype=torch.int32), res.meta, res.tables,
            *res.density, *res.color)
    kw = dict(block_size=B, chunk=C, group=group, near=ops.NEAR32,
              far=ops.FAR32, log_eps_t=ops.LOG_EPS_T32, early_term=True,
              white_background=True, with_color=True, per_ray_exit=per_ray)
    return args, kw


def _first_chunk_color_input(args, kw):
    """[geo, SH] of every anchor sample of chunk 0 (which every block
    runs), in the plain march's (block, ray, anchor) order."""
    o, d, sh, budgets, meta, tables, wd, dims_d, _, _ = args
    B, C, group = kw["block_size"], kw["chunk"], kw["group"]
    nb = budgets.shape[0]
    dt = torch.full((nb,), kw["far"] - kw["near"]) / budgets.float()
    jj = torch.arange(0, C, group).float()
    ts = kw["near"] + (jj[None, :] + 0.5) * dt[:, None]          # (nb, A)
    o3, d3 = o.reshape(nb, B, 1, 3), d.reshape(nb, B, 1, 3)
    pts = o3 + ts[:, None, :, None] * d3                         # (nb, B, A, 3)
    h = FM.chain_plain(HE.hash_encode_plain(pts.reshape(-1, 3), meta, tables),
                       wd, dims_d)
    A, S = jj.shape[0], sh.shape[1]
    shp = sh.reshape(nb, B, 1, S).expand(nb, B, A, S).reshape(-1, S)
    return torch.cat([h[:, 1:], shp], dim=1)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_march_colors_are_the_fma_color_chain(name, monkeypatch):
    """The plain march's anchor colors are color_mlp_plain's on the [geo,
    SH] rows of its anchor samples, bit for bit: one rounding per
    multiply-add, not the density chain's two."""
    args, kw = _march_inputs(name)
    calls = []

    def spy(cin, w, dims):
        out = FM.color_mlp_plain(cin, w, dims)
        calls.append((cin, out))
        return out

    monkeypatch.setattr(FMA, "color_mlp_plain", spy)
    FMA.fused_march_plain(*args, **kw)
    cin, cols = calls[0]
    assert torch.equal(cin, _first_chunk_color_input(args, kw))
    wc, dims_c = args[-2], args[-1]
    fma = FM.sigmoid_plain(FM.chain_plain(cin, wc, dims_c,
                                          dense=FM.dense_plain_fma))
    apart = FM.sigmoid_plain(FM.chain_plain(cin, wc, dims_c))
    assert torch.equal(cols, fma)
    assert not torch.equal(cols, apart)


@pytest.mark.parametrize("name", list(CASES))
def test_color_rounding_moves_no_counter(name, monkeypatch):
    """With the color chain rounding each product and sum apart instead,
    the chunk counters, acc and depth are the same to the bit, and rgb
    moves by rounding only."""
    args, kw = _march_inputs(name)
    want = FMA.fused_march_plain(*args, **kw)
    monkeypatch.setattr(FMA, "color_mlp_plain", lambda cin, w, dims:
                        FM.sigmoid_plain(FM.chain_plain(cin, w, dims)))
    got = FMA.fused_march_plain(*args, **kw)
    for lane in (0, 4, 5, 6, 7):
        assert torch.equal(got[:, lane], want[:, lane]), lane
    np.testing.assert_allclose(got[:, 1:4].numpy(), want[:, 1:4].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_march_shared_memory_at_the_paper_widths():
    """Both chains' weights (160,768 B), then per warp group its
    activations of 32 rows x 128 (16,384 B) and per tile row the chunk's
    sigmas, two anchor colors, the SH features and two flags, and the
    (16, 3) meta: three groups where they fit, two at chunk 64."""
    smem = FMA.smem_bytes(PAPER_DENSITY, PAPER_COLOR, 16, 32, 16)
    assert FMA.warp_groups(PAPER_DENSITY, PAPER_COLOR, 16, 32, 16) == 3
    assert smem == 160_768 + 3 * (16_384 + 4 * 32 * (32 + 6 + 16 + 2)) + 192
    assert smem == 231_616 <= FM.SMEM_LIMIT
    assert FMA.warp_groups(PAPER_DENSITY, PAPER_COLOR, 16, FMA.MAX_CHUNK,
                           16) == 2
    assert FMA.smem_bytes(PAPER_DENSITY, PAPER_COLOR, 16, FMA.MAX_CHUNK,
                          16) == 216_256 <= FM.SMEM_LIMIT
    assert FMA.smem_bytes(PAPER_DENSITY, PAPER_COLOR, 0, 32, 16) == 225_472


def _meta_march(dims_d=PAPER_DENSITY, dims_c=PAPER_COLOR, L=16, F=2, N=2,
                B=64):
    """Inputs of the march's CUDA path as meta tensors (shapes, no data)."""
    meta = torch.device("meta")
    S = dims_c[0] - dims_d[-1] + 1
    return (torch.empty((N * B, 3), device=meta),
            torch.empty((N * B, 3), device=meta),
            torch.empty((N * B, S), device=meta),
            torch.empty((N,), dtype=torch.int32, device=meta),
            torch.empty((L, 3), dtype=torch.int32, device=meta),
            torch.empty((L, 1 << 10, F), device=meta),
            torch.empty((FM.chain_size(dims_d),), device=meta), dims_d,
            torch.empty((FM.chain_size(dims_c),), device=meta), dims_c)


REFUSED = {
    "chunk_over_max": (dict(chunk=FMA.MAX_CHUNK + 1), {}, "chunk"),
    "chunk_zero": (dict(chunk=0), {}, "chunk"),
    "group_zero": (dict(group=0), {}, "group"),
    "hidden_not_in_fours": ({}, dict(dims_d=(32, 62, 16)), "multiples of 4"),
    "color_too_wide": ({}, dict(dims_c=(31,) + (128,) * 6 + (3,)),
                       "shared memory"),
    "encoding_width": ({}, dict(L=8), "widths"),
    "feature_dim": ({}, dict(L=2, F=16, dims_d=(32, 64, 16)), "tables"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_fused_march_refuses_before_launch(case):
    """Off the CPU the wrapper checks the shapes before it builds or
    launches anything."""
    kw_march, kw_inputs, match = REFUSED[case]
    kw = dict(block_size=64, chunk=32, group=2, near=0.1, far=4.0,
              log_eps_t=-9.0)
    kw.update(kw_march)
    with pytest.raises(ValueError, match=match):
        FMA.fused_march(*_meta_march(**kw_inputs), **kw)
