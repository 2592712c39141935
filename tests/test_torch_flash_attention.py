"""Port parity: flash attention's plain version (the wrapper's CPU path)
against the JAX ``models.attention.attend_full`` oracle, and against the
JAX Pallas kernel in interpret mode (slow tier, like
test_flash_attention.py); the port's gemma2 widths against the
reference's config."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_27b as j_gemma
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import attention as A
from repro_torch.configs import gemma2_27b as t_gemma
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from test_torch_gpu import KEY_TILE_CASES, direct_key_tiles

# the reference kernel's own tolerance (tests/test_flash_attention.py)
RTOL, ATOL = 2e-4, 2e-5
# bf16 plain version against attend_full on the same bf16 values: atol and
# a limit on ||got - want|| / ||want||, 2-3x the error at these shapes
# (max 7.8e-3 at every output magnitude, half a bf16 step of the largest
# outputs; norm 1.8-2.0e-3): the plain version rounds P to bf16 before
# P.V and its output to bf16, the oracle neither.
BF16_ATOL, BF16_REL = 2e-2, 5e-3
SHAPES = {"gqa": (2, 256, 4, 2, 64), "mha": (1, 128, 4, 4, 32),
          "mqa": (1, 512, 8, 1, 64)}
# head_dim 256: gemma3-12b's GQA 16 / 8 and paligemma-3b's MQA 8 / 1
WIDE_SHAPES = {"gqa 16/8": (1, 160, 16, 8, 256), "mqa 8/1": (1, 200, 8, 1, 256)}
H100_SMEM_PER_CTA = 232_448          # 227 KB, the most one CTA can have


def _qkv(B, S, H, KV, Dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, Dh)).astype(dtype)
    k = rng.normal(size=(B, S, KV, Dh)).astype(dtype)
    v = rng.normal(size=(B, S, KV, Dh)).astype(dtype)
    return q, k, v


def _assert_bf16_close(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
    assert np.linalg.norm(got - want) <= BF16_REL * np.linalg.norm(want)


def _oracle(q, k, v, window, cap):
    pos = jnp.arange(q.shape[1], dtype=jnp.int32)
    return np.asarray(A.attend_full(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), pos, pos, window=window,
                                    softcap_val=cap))


@pytest.mark.parametrize("window,cap", [(0, 0.0), (128, 0.0), (0, 50.0)])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_flash_plain_matches_attend_full(shape, window, cap):
    B, S, H, KV, Dh = SHAPES[shape]
    q, k, v = _qkv(B, S, H, KV, Dh, seed=S + H + window)
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    window=window, softcap=cap)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, window, cap),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (64, 0.0), (0, 50.0)])
@pytest.mark.parametrize("shape", list(WIDE_SHAPES))
def test_flash_plain_head_dim_256_matches_attend_full(shape, window, cap):
    B, S, H, KV, Dh = WIDE_SHAPES[shape]
    q, k, v = _qkv(B, S, H, KV, Dh, seed=S + H + window)
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    window=window, softcap=cap)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, window, cap),
                               rtol=RTOL, atol=ATOL)


def test_flash_plain_ragged_window_and_softcap():
    """A length off the tile grid, and a window shorter than a key tile:
    rows whose first key tiles are wholly masked carry nothing from them."""
    q, k, v = _qkv(1, 200, 4, 2, 32, seed=3)
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    window=48, softcap=30.0)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, 48, 30.0),
                               rtol=RTOL, atol=ATOL)


def test_flash_plain_bf16_io():
    q, k, v = _qkv(1, 128, 2, 2, 32, seed=0)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = tfa.flash_attention_plain(*bf)
    assert got.dtype == torch.bfloat16
    want = _oracle(*(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in bf),
                   0, 0.0)
    _assert_bf16_close(got, want)


def test_flash_wrapper_runs_the_plain_version_on_the_cpu():
    q, k, v = map(torch.from_numpy, _qkv(1, 64, 4, 2, 16, seed=4))
    tops.reset_launch_counts()
    got = tfa.flash_attention(q, k, v, window=8, softcap=50.0)
    assert torch.equal(got, tfa.flash_attention_plain(q, k, v, 8, 50.0))
    assert tops.launch_counts()["flash_attention"] == 0


@pytest.mark.slow
def test_flash_plain_matches_pallas_kernel():
    q, k, v = _qkv(2, 256, 4, 2, 64, seed=9)
    want = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), window=128,
                              softcap=50.0))
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    window=128, softcap=50.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_gemma2_attention_widths_match_the_reference(name):
    j, t = getattr(j_gemma, name), getattr(t_gemma, name)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name


# ---- the kernel's tile and grid arithmetic (kernels/flash_attention.py)

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _check_key_tiles(dtype, S, window, Dh):
    dt = DTYPES[dtype]
    want = direct_key_tiles(S, window, dt, Dh)
    assert tfa.grid(3, S, 5, Dh, dt) == (len(want), 15)
    for q0, tiles in want.items():
        assert list(tfa.key_tiles(q0, S, window, Dh, dt)) == tiles, q0


@pytest.mark.parametrize("dtype,S,window", KEY_TILE_CASES)
def test_flash_key_tiles_match_a_direct_count(dtype, S, window):
    """For every query tile, the key tiles the wrapper reckons the kernel
    loads are exactly those holding an unmasked (query, key) pair, also for
    a window whose first key falls mid-tile and a length off the tile grid.
    (``test_torch_gpu`` holds the compiled kernels' range to the same
    count.)"""
    _check_key_tiles(dtype, S, window, 128)


@pytest.mark.parametrize("dtype,S,window", KEY_TILE_CASES)
def test_flash_key_tiles_at_head_dim_256_match_a_direct_count(dtype, S,
                                                               window):
    """The same at the head-dim-256 tiles (64 query rows, 32-key tiles)."""
    _check_key_tiles(dtype, S, window, 256)


def _direct_smem(Dh, dt, qb, kb):
    """The bytes of the tiles, counted one by one: K and V tiles of kb rows,
    two buffers; Q's tile of qb rows where it is not staged in a K/V
    buffer; fp32's P tile of qb rows of kb + 8 floats."""
    item = 2 if dt == torch.bfloat16 else 4
    row = Dh * item + 16
    want = row * 2 * 2 * kb
    if dt == torch.float32:
        want += row * qb + qb * (kb + 8) * 4
    elif Dh > 128:
        want += row * qb
    else:
        assert qb <= 2 * kb
    assert row % 16 == 0 and (row // 16) % 2 == 1    # odd: no bank conflicts
    return want


@pytest.mark.parametrize("Dh", [16, 48, 64, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_smem_counts_the_tiles_and_fits_two_ctas(dtype, Dh):
    """Shared memory up to 128 dims: two buffers each of a K and a V tile
    (rows padded by 16 B); for bf16 Q's tile fits in one of them, for fp32
    it has its own and the P tile; two CTAs fit on one SM at every head
    width (the H100's 228 KB, 1 KB of it reserved per CTA)."""
    dt = DTYPES[dtype]
    qb, kb = tfa.tiles(Dh, dt)
    assert (qb, kb) == (tfa.QUERY_TILE[dt], tfa.KEY_TILE[dt])
    assert tfa.smem_bytes(Dh, dt) == _direct_smem(Dh, dt, qb, kb)
    assert 2 * (tfa.smem_bytes(Dh, dt) + 1024) <= 228 * 1024


@pytest.mark.parametrize("Dh", [144, 192, 256])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_smem_past_128_fits_one_cta(dtype, Dh):
    """Past 128 dims the tiles are the 256 bound's (bf16: 64 query rows
    over 32-key tiles, Q's tile its own; fp32: 64 over 32), counted the same
    way, within the 227 KB one CTA can have; bf16's two CTAs still fit one
    SM."""
    dt = DTYPES[dtype]
    qb, kb = tfa.tiles(Dh, dt)
    assert (qb, kb) == (64, 32)
    assert tfa.head_dim_bound(Dh) == 256
    assert tfa.smem_bytes(Dh, dt) == _direct_smem(Dh, dt, qb, kb)
    assert tfa.smem_bytes(Dh, dt) <= H100_SMEM_PER_CTA
    if dt == torch.bfloat16:
        assert 2 * (tfa.smem_bytes(Dh, dt) + 1024) <= 228 * 1024
    assert tfa.grid(2, 4608, 16, Dh, dt) == (72, 32)


def test_flash_wrapper_refuses_past_256_before_launch():
    """A head_dim past 256, or not a multiple of 16, is refused before any
    launch (on a meta tensor: nothing builds or runs)."""
    assert tfa.MAX_HEAD_DIM == 256
    for Dh in (272, 200):
        q = torch.empty((1, 8, 2, Dh), device="meta")
        with pytest.raises(ValueError, match="up to 256"):
            tfa.flash_attention(q, q, q)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (128, 0.0), (0, 50.0)])
def test_flash_plain_bf16_with_rounded_p_matches_attend_full(window, cap):
    """The plain version on bf16 inputs, P rounded to bf16 before P.V as
    the kernel does, against the JAX oracle on the same bf16 values."""
    q, k, v = _qkv(2, 256, 4, 2, 64, seed=11 + window)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = tfa.flash_attention_plain(*bf, window=window, softcap=cap)
    assert got.dtype == torch.bfloat16
    want = _oracle(*(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in bf),
                   window, cap)
    _assert_bf16_close(got, want)


def test_flash_plain_bf16_rounds_p_before_pv():
    """Two keys whose weights, 1 and exp(-0.001), are equal once rounded
    to bf16, against values +100 and -100: with P rounded before P.V (as
    the kernel does) the second row's output is exactly 0; unrounded it
    would be about -0.05."""
    Dh = 16
    q = torch.zeros(1, 2, 1, Dh)
    k = torch.zeros(1, 2, 1, Dh)
    v = torch.zeros(1, 2, 1, Dh)
    q[0, :, 0, 0] = 1.0
    k[0, 0, 0, 0] = -0.004          # score 0.25 * -0.004 = -0.001
    v[0, 0, 0, :], v[0, 1, 0, :] = 100.0, -100.0
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    got = tfa.flash_attention_plain(*bf).float()
    assert torch.all(got[0, 0, 0] == 100.0)
    assert torch.all(got[0, 1, 0] == 0.0)
    unrounded = tfa.flash_attention_plain(*(t.float() for t in bf))
    assert float(unrounded[0, 1, 0, 0]) < -0.04
