"""Port parity: ``repro_torch.models.attention`` against
``repro.models.attention`` (RoPE, the masks, ``attend_full``,
``attend_chunked``, the ring and linear caches, stepwise decode), and the
kernel route's plain version (``flash_attention_plain``) at the smoke
widths against the reference's ``attend_chunked``; float32, rtol 1e-4 /
atol 1e-5, inputs from a numpy seed (after ``tests/test_attention.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro.models import attention as JA
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as TA

RTOL, ATOL = 1e-4, 1e-5


def _qkv(seed, B=2, S=32, H=4, KV=2, Dh=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh)))


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches(theta):
    x = np.random.default_rng(0).standard_normal((2, 9, 3, 16)).astype(
        np.float32)
    pos = np.arange(9, dtype=np.int32)[None] + 100
    want = JA.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(TA.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           want)
    _close(TA.rope_freqs(16, theta), JA.rope_freqs(16, theta), 1e-6, 0)


@pytest.mark.parametrize("window", [0, 1, 5])
def test_mask_matches(window):
    q = np.arange(12, dtype=np.int32)
    k = np.concatenate([np.arange(10), [2 ** 31 - 1, 2 ** 31 - 1]]).astype(
        np.int32)
    want = np.asarray(JA._mask(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(window)))
    got = TA._mask(torch.from_numpy(q).long(), torch.from_numpy(k).long(),
                   window)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (8, 0.0), (0, 50.0),
                                        (8, 50.0)])
def test_attend_full_matches(window, cap):
    q, k, v = _qkv(1)
    pos = np.arange(32, dtype=np.int32)
    want = JA.attend_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(pos), jnp.asarray(pos), window=window,
                          softcap_val=cap)
    tp = torch.from_numpy(pos).long()
    _close(TA.attend_full(*_t(q, k, v), tp, tp, window, cap), want)


@pytest.mark.parametrize("window,cap,chunk,S", [
    (0, 0.0, 8, 32), (8, 50.0, 8, 32), (5, 30.0, 7, 30),   # ragged chunk
    (0, 50.0, 32, 32)])
def test_attend_chunked_matches(window, cap, chunk, S):
    q, k, v = _qkv(2, S=S)
    pos = np.arange(S, dtype=np.int32)
    want = JA.attend_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos), jnp.asarray(pos), window=window,
                             softcap_val=cap, chunk=chunk)
    tp = torch.from_numpy(pos).long()
    _close(TA.attend_chunked(*_t(q, k, v), tp, tp, window, cap, chunk), want)


def test_attend_chunked_with_extra_mask_matches():
    q, k, v = _qkv(3, S=24)
    pos = np.arange(24, dtype=np.int32)
    em = (pos[:, None] < 8) & (pos[None, :] < 8)     # a bidirectional prefix
    want = JA.attend_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos), jnp.asarray(pos), chunk=10,
                             extra_mask=jnp.asarray(em))
    tp = torch.from_numpy(pos).long()
    got = TA.attend_chunked(*_t(q, k, v), tp, tp, chunk=10,
                            extra_mask=torch.from_numpy(em))
    _close(got, want)
    causal = TA.attend_full(*_t(q, k, v), tp, tp)
    assert float((got[:, 0] - causal[:, 0]).abs().max()) > 1e-4


@pytest.mark.parametrize("ring,pos", [(True, 6), (True, 2), (True, 13),
                                      (False, 2), (False, 4)])
def test_cache_slot_positions_match(ring, pos):
    jc = JA.init_cache(1, 4, 2, 8, jnp.float32)
    tc = TA.init_cache(1, 4, 2, 8, torch.float32, "cpu")
    want = np.asarray(JA.cache_slot_positions(jc, pos, ring=ring))
    np.testing.assert_array_equal(
        TA.cache_slot_positions(tc, pos, ring).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("ring,slots", [(True, 4), (False, 12)])
def test_stepwise_decode_matches(ring, slots):
    """Tokens fed one by one through a ring (window 4) or a linear cache:
    each step's cache and output equal the reference's."""
    B, S, H, KV, Dh, W = 1, 12, 2, 2, 8, 4
    q, k, v = _qkv(4, B=B, S=S, H=H, KV=KV, Dh=Dh)
    window = W if ring else 0
    jc = JA.init_cache(B, slots, KV, Dh, jnp.float32)
    tc = TA.init_cache(B, slots, KV, Dh, torch.float32, "cpu")
    tq, tk, tv = _t(q, k, v)
    for t in range(S):
        jc = JA.cache_update(jc, jnp.asarray(k[:, t:t + 1]),
                             jnp.asarray(v[:, t:t + 1]), jnp.asarray(t), ring)
        tc = TA.cache_update(tc, tk[:, t:t + 1], tv[:, t:t + 1], t, ring)
        np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
        np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
        want = JA.decode_attend(jnp.asarray(q[:, t:t + 1]), jc, jnp.asarray(t),
                                ring, KV, window=window, softcap_val=50.0)
        _close(TA.decode_attend(tq[:, t:t + 1], tc, t, ring, KV, window, 50.0),
               want)


@pytest.mark.parametrize("arch", ["gemma2_27b", "minitron_8b", "qwen3_14b",
                                  "gemma3_12b"])
def test_kernel_route_plain_matches_attend_chunked(arch):
    """The plain version of the prefill kernel at each dense smoke arch's
    widths, on its local and global layers, against ``attend_chunked``."""
    cfg = tconfigs.get_smoke(arch)
    S = 20                                  # longer than the smoke window
    q, k, v = _qkv(5, B=2, S=S, H=cfg.n_heads, KV=cfg.n_kv_heads,
                   Dh=cfg.resolved_head_dim)
    pos = jnp.arange(S, dtype=jnp.int32)
    for window in sorted(set(cfg.layer_kinds())):
        want = JA.attend_chunked(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), pos, pos, window=window,
                                 softcap_val=cfg.attn_softcap, chunk=S)
        _close(FA.flash_attention_plain(*_t(q, k, v), window,
                                        cfg.attn_softcap), want)
