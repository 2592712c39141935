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

# the reference kernel's own tolerance (tests/test_flash_attention.py)
RTOL, ATOL = 2e-4, 2e-5
SHAPES = {"gqa": (2, 256, 4, 2, 64), "mha": (1, 128, 4, 4, 32),
          "mqa": (1, 512, 8, 1, 64)}


def _qkv(B, S, H, KV, Dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, Dh)).astype(dtype)
    k = rng.normal(size=(B, S, KV, Dh)).astype(dtype)
    v = rng.normal(size=(B, S, KV, Dh)).astype(dtype)
    return q, k, v


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
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


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
