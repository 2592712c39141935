"""Port parity: the Mamba-2 SSD layer (``repro_torch.models.ssm``)
against the reference's ``repro.models.ssm``.

``ssd_scan`` (which never builds the reference's (B, C, Q, H, P, N)
temporary) equals the reference's ``ssd_scan`` and the naive recurrence
(``ssd_reference``, both packages') within the reference's tolerance,
rtol / atol 1e-4 (``tests/test_ssm.py:36``), output and final state.
``ssm_init`` equals the reference's value for value (``A_log`` through
XLA's linspace and log).  ``_causal_conv`` / ``_split_bcx`` match;
``ssm_apply_with_state`` at a length that needs padding (20 tokens, chunk
8) matches output and handed-off state, and ``ssm_step`` from that state
matches the reference's steps, at the test config of ``tests/test_ssm.py``
and at mamba2's and hymba's smoke widths.  The reference runs eagerly,
once per case."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JModelConfig
from repro.models.params import split as jsplit
from repro_torch import prng
from repro_torch.models import ssm as tssm
from repro_torch.models import params as tpp
from repro_torch.models.config import ModelConfig as TModelConfig

RTOL = ATOL = 1e-4
TEST_CFG = dict(name="ssm-test", family="ssm", n_layers=1, d_model=32,
                n_heads=1, n_kv_heads=1, d_ff=0, vocab=64, ssm_state=8,
                ssm_head_dim=8, ssm_expand=2, ssm_chunk=8, dtype="float32")
CONFIGS = {"test": (JModelConfig(**TEST_CFG), TModelConfig(**TEST_CFG))}
for _arch in ("mamba2_780m", "hymba_1_5b"):
    CONFIGS[_arch] = tuple(
        dataclasses.replace(c.get_smoke(_arch), dtype="float32", ssm_chunk=8)
        for c in (jconfigs, tconfigs))
PREFILL, STEPS = 20, 4          # 20 tokens pad to 24 at chunk 8


def _scan_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, S, H, P)).astype(np.float32)
    bm = (rng.standard_normal((B, S, 1, N)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((B, S, 1, N)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(np.linspace(-1.0, 1.0, H)).astype(np.float32)
    D = rng.uniform(0.5, 1.5, H).astype(np.float32)
    return xs, bm, cm, dt, A, D


@pytest.mark.parametrize("S,chunk", [(8, 4), (8, 8), (32, 4), (32, 8),
                                     (48, 16), (24, 24)])
def test_ssd_scan_matches_reference(S, chunk):
    args = _scan_inputs(S * 100 + chunk, 2, S, 4, 8, 8)
    jy, jh = jssm.ssd_scan(*map(jnp.asarray, args), chunk)
    jref = jssm.ssd_reference(*map(jnp.asarray, args))
    ty, th = tssm.ssd_scan(*map(torch.from_numpy, args), chunk)
    tref = tssm.ssd_reference(*map(torch.from_numpy, args))
    assert ty.dtype == th.dtype == torch.float32
    for got, want in ((ty, jy), (th, jh), (ty, jref), (tref, jref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_ssd_scan_refuses_a_ragged_length():
    args = map(torch.from_numpy, _scan_inputs(0, 1, 10, 2, 4, 4))
    with pytest.raises(ValueError, match="chunk"):
        tssm.ssd_scan(*args, chunk=4)


@pytest.fixture(scope="module", params=list(CONFIGS))
def block(request):
    """The reference's SSM block at a config (PRNGKey(0)), seeded inputs,
    and its outputs: the padded prefill with its state, then STEPS decode
    steps from that state."""
    jc, tc = CONFIGS[request.param]
    jp, _ = jsplit(jssm.ssm_init(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, PREFILL + STEPS, jc.d_model)) * 0.5).astype(
        np.float32)
    jout, jstate = jssm.ssm_apply_with_state(jp, jnp.asarray(x[:, :PREFILL]),
                                             jc)
    steps, state = [], jstate
    for t in range(PREFILL, PREFILL + STEPS):
        o, state = jssm.ssm_step(jp, jnp.asarray(x[:, t:t + 1]), state, jc)
        steps.append(np.asarray(o))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, x=x, jout=np.asarray(jout),
                jstate=jstate, jsteps=steps, jfinal=state)


def test_ssm_init_equals_reference(block):
    tv, axes = tpp.split(tssm.ssm_init(prng.PRNGKey(0), block["tc"],
                                       device="cpu"))
    _, jaxes = jsplit(jssm.ssm_init(jax.random.PRNGKey(0), block["jc"]))
    assert sorted(tv) == sorted(block["jp"])
    for k, w in block["jp"].items():
        assert tv[k].dtype == torch.float32
        np.testing.assert_array_equal(tv[k].numpy(), np.asarray(w), err_msg=k)
        assert axes[k] == jaxes[k]


def test_conv_and_projections_match(block):
    jc, tc, x = block["jc"], block["tc"], block["x"][:, :PREFILL]
    want = jssm._split_bcx(block["jp"], jnp.asarray(x), jc, return_raw=True,
                           valid_len=PREFILL - 3)
    got = tssm._split_bcx(block["tp"], torch.from_numpy(x), tc,
                          return_raw=True, valid_len=PREFILL - 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    assert float(got[3][:, PREFILL - 3:].abs().max()) == 0.0   # dt masked


def test_prefill_with_padding_and_state_match(block):
    assert PREFILL % block["tc"].ssm_chunk      # the padded path
    out, state = tssm.ssm_apply_with_state(
        block["tp"], torch.from_numpy(block["x"][:, :PREFILL]), block["tc"])
    np.testing.assert_allclose(out.numpy(), block["jout"], rtol=RTOL,
                               atol=ATOL)
    for got, want in zip(state, block["jstate"]):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_decode_steps_from_the_handed_off_state_match(block):
    tc, x = block["tc"], block["x"]
    _, state = tssm.ssm_apply_with_state(
        block["tp"], torch.from_numpy(x[:, :PREFILL]), tc)
    for i, t in enumerate(range(PREFILL, PREFILL + STEPS)):
        o, state = tssm.ssm_step(block["tp"], torch.from_numpy(x[:, t:t + 1]),
                                 state, tc)
        np.testing.assert_allclose(o.numpy(), block["jsteps"][i], rtol=RTOL,
                                   atol=ATOL)
    for got, want in zip(state, block["jfinal"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    fresh = tssm.ssm_init_state(tc, 3, device="cpu")
    want = jssm.ssm_init_state(block["jc"], 3)
    assert [tuple(a.shape) for a in fresh] == [a.shape for a in want]
    assert fresh.h.dtype == torch.float32


def test_prefill_then_steps_equal_one_prefill(block):
    """The state hand-off: prefill then steps equals one longer prefill
    (``tests/test_ssm.py``'s property, at the reference's 2e-3)."""
    tc, x = block["tc"], torch.from_numpy(block["x"])
    full = tssm.ssm_apply(block["tp"], x, tc)
    out, state = tssm.ssm_apply_with_state(block["tp"], x[:, :PREFILL], tc)
    outs = [out]
    for t in range(PREFILL, PREFILL + STEPS):
        o, state = tssm.ssm_step(block["tp"], x[:, t:t + 1], state, tc)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_bf16_rounds_the_1d_leaves_where_the_reference_does():
    """In bf16 the reference's ``cast_tree`` rounds A_log, D, dt_bias and
    norm to bf16 at use; the port stores them in float32 and rounds them
    at the same place, so the port's bf16 block on float32-stored 1-D
    leaves equals the block on leaves rounded beforehand, bit for bit."""
    tc = dataclasses.replace(tconfigs.get_smoke("mamba2_780m"),
                             dtype="bfloat16")
    p, _ = tpp.split(tssm.ssm_init(prng.PRNGKey(3), tc, torch.bfloat16,
                                   device="cpu"))
    p["A_log"] = p["A_log"] + 0.013        # values bf16 cannot hold
    p["D"] = p["D"] * 1.0031
    p["dt_bias"] = p["dt_bias"] + 0.0017
    p["norm"] = p["norm"] + 0.0029
    rounded = {k: v.to(torch.bfloat16) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 20, tc.d_model)).astype(np.float32)).to(torch.bfloat16)
    a, sa = tssm.ssm_apply_with_state(p, x, tc)
    b, sb = tssm.ssm_apply_with_state(rounded, x, tc)
    assert torch.equal(a, b) and all(torch.equal(u, v) for u, v in zip(sa, sb))
    assert p["A_log"].dtype == torch.float32
