"""Port parity: the capacity-routed MoE (``repro_torch.models.ffn``:
``moe_init``, ``_route``, ``moe_apply``, ``moe_aux_loss``) against the
reference's ``repro.models.ffn``.

``_route`` on the same float32 logits gives the reference's dispatch and
combine masks exactly: random logits, exactly tied logits (the lower
expert index first, as ``jax.lax.top_k``) and the reference's
capacity-overflow case (``tests/test_moe.py:44-50``).  The router's
softmax is XLA's op for op (``softmax_f32``) and equal to it bit for bit.
``moe_aux_loss`` is within 1e-6.  ``moe_apply`` with shared experts on
the reference's params carried across is within rtol 1e-4 / atol 1e-5, at
the smoke configs' capacity (with drops) and at 8.0 (none), with the same
top-k sets; the smallest k-th / (k+1)-th router margin over the tokens is
asserted above 1e-5, so a flip could not hide in the comparison.  The
reference is called once per case, eagerly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import ffn as jffn
from repro.models.params import split as jsplit
from repro_torch import prng
from repro_torch.models import ffn as tffn
from repro_torch.models import params as tpp

RTOL, ATOL = 1e-4, 1e-5
MIN_MARGIN = 1e-5
# (G, S, E, k, capacity, kind): the widths of the smoke configs and of
# deepseek-moe-16b's decode (capacity 1) and 512-token groups
ROUTES = [(2, 16, 4, 2, 10, "random"), (3, 64, 8, 2, 20, "random"),
          (2, 32, 16, 4, 6, "random"), (4, 512, 64, 6, 60, "random"),
          (4, 1, 64, 6, 1, "random"), (2, 16, 4, 2, 10, "tied"),
          (2, 64, 8, 2, 12, "tied"), (3, 128, 64, 6, 30, "tied"),
          (1, 16, 4, 1, 4, "overflow"), (2, 64, 64, 6, 5, "overflow")]


def _logits(G, S, E, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.standard_normal((G, S, E)) * 2).astype(np.float32)
    if kind == "tied":     # few distinct values: many exact ties a token
        return rng.integers(-2, 3, (G, S, E)).astype(np.float32)
    out = np.zeros((G, S, E), np.float32)    # every token picks expert 0
    out[..., 0] = 10.0
    return out


@pytest.mark.parametrize("G,S,E,k,C,kind", ROUTES)
def test_route_equals_reference_exactly(G, S, E, k, C, kind):
    x = _logits(G, S, E, kind)
    jd, jc = jffn._route(jnp.asarray(x), k, C)
    td, tc = tffn._route(torch.from_numpy(x), k, C)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    if kind == "overflow" and k == 1:        # tests/test_moe.py's case
        assert float(td[..., 0, :].sum()) == C


@pytest.mark.parametrize("E", [4, 8, 16, 33, 64, 96])
def test_softmax_and_top_k_equal_xla(E):
    """The router's float32 softmax bit for bit (XLA's exp and reduce
    order), and top-k's order on ties."""
    x = _logits(1, 256, E, "random", seed=E)
    want = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))
    got = tffn.softmax_f32(torch.from_numpy(x)).numpy()
    if E <= tffn.SUM_WINDOW or E % tffn.SUM_WINDOW == 0:
        np.testing.assert_array_equal(got, want)
    else:                   # XLA splits other widths otherwise: not exact
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    tied = _logits(1, 256, E, "tied", seed=E)
    jv, ji = jax.lax.top_k(jnp.asarray(tied), 3)
    tv, ti = tffn.top_k(torch.from_numpy(tied), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_xla_exp_equals_jnp_exp():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-110.0, 0.0, 200_000),
                        rng.uniform(-2.0, 2.0, 200_000),
                        [0.0, -0.0, -87.5, -88.7, -200.0, -np.inf, 88.0]])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(prng.xla_exp(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.exp(jnp.asarray(x))))


@pytest.mark.parametrize("kind", ["random", "tied", "overflow"])
def test_aux_loss_matches(kind):
    for G, S, E, k in ((2, 64, 4, 2), (3, 128, 64, 6)):
        x = _logits(G, S, E, kind)
        want = float(jffn.moe_aux_loss(jnp.asarray(x), k))
        got = float(tffn.moe_aux_loss(torch.from_numpy(x), k))
        # a mean of 384 floats in another order: 1e-6 of the loss
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)
    balanced = torch.zeros((2, 64, 4))
    skew = balanced.clone()
    skew[..., 0] = 5.0
    assert float(tffn.moe_aux_loss(skew, 2)) > float(
        tffn.moe_aux_loss(balanced, 2))


@pytest.fixture(scope="module", params=["deepseek_moe_16b", "dbrx_132b"])
def moe(request):
    """A smoke config's MoE block, drawn by the reference from
    PRNGKey(1), and seeded activations."""
    jc = dataclasses.replace(jconfigs.get_smoke(request.param),
                             dtype="float32")
    tc = dataclasses.replace(tconfigs.get_smoke(request.param),
                             dtype="float32")
    jp, _ = jsplit(jffn.moe_init(jax.random.PRNGKey(1), jc))
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 64, jc.d_model)) * 0.5).astype(np.float32)
    return jc, tc, jp, x


def test_moe_init_equals_reference(moe):
    jc, tc, jp, _ = moe
    tv, axes = tpp.split(tffn.moe_init(prng.PRNGKey(1), tc, device="cpu"))
    _, jaxes = jsplit(jffn.moe_init(jax.random.PRNGKey(1), jc))
    want = jax.tree.leaves(jp)
    got = tpp.tree_leaves(tv)
    assert len(got) == len(want) and ("shared" in tv) == bool(
        tc.n_shared_experts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tpp.tree_leaves(axes) == jax.tree.leaves(
        jaxes, is_leaf=lambda a: isinstance(a, tuple))


@pytest.mark.parametrize("capacity_factor", [None, 8.0])
def test_moe_apply_matches(moe, capacity_factor):
    jc, tc, jp, x = moe
    if capacity_factor:
        jc = dataclasses.replace(jc, capacity_factor=capacity_factor)
        tc = dataclasses.replace(tc, capacity_factor=capacity_factor)
    tp = {k: (torch.from_numpy(np.array(v)) if not isinstance(v, dict) else
              {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()})
          for k, v in jp.items()}
    # the routing is the reference's: top-k sets equal, margins clear
    logits = x.reshape(-1, jc.d_model) @ np.asarray(jp["router"])
    jprobs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    tlogits = torch.from_numpy(x).reshape(-1, tc.d_model) @ tp["router"]
    tprobs = tffn.softmax_f32(tlogits)
    _, ti = tffn.top_k(tprobs, tc.top_k)
    _, ji = jax.lax.top_k(jnp.asarray(jprobs), jc.top_k)
    assert (np.sort(ti.numpy(), -1) == np.sort(np.asarray(ji), -1)).all()
    srt = np.sort(jprobs, axis=-1)[:, ::-1]
    margin = float((srt[:, jc.top_k - 1] - srt[:, jc.top_k]).min())
    print(f"{jc.name}: smallest k-th / (k+1)-th router margin {margin:.3e}")
    assert margin > MIN_MARGIN
    want = np.asarray(jffn.moe_apply(jp, jnp.asarray(x), jc, jc.act))
    got = tffn.moe_apply(tp, torch.from_numpy(x), tc, tc.act).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_moe_apply_refuses_what_the_reference_asserts():
    """Groups must divide the tokens: (B * S) % min(group, S) == 0."""
    tc = dataclasses.replace(tconfigs.get_smoke("deepseek_moe_16b"),
                             dtype="float32", moe_group_size=48)
    tp, _ = tpp.split(tffn.moe_init(prng.PRNGKey(0), tc, device="cpu"))
    assert tffn.moe_apply(tp, torch.zeros((2, 24, tc.d_model)), tc).shape == (
        2, 24, tc.d_model)
    with pytest.raises(ValueError, match=r"\(B \* S\) % gs == 0"):
        tffn.moe_apply(tp, torch.zeros((1, 50, tc.d_model)), tc)
    assert tffn.capacity_of(tconfigs.get("deepseek-moe-16b"), 1024) == 120
    assert tffn.capacity_of(tconfigs.get("deepseek-moe-16b"), 512) == 60
    assert tffn.capacity_of(tconfigs.get("deepseek-moe-16b"), 1) == 1
