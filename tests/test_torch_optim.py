"""Port parity: AdamW, the global-norm clip and the learning-rate
schedules against the reference's (``repro.optim``), on numpy-made params
and grads.  The update is the reference's formula op for op in float32,
so it holds at rtol 1e-6 / atol 1e-9 (``pow`` and ``sqrt`` may round an
ulp apart across the two backends); the schedules to float32 rounding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt

RTOL, ATOL = 1e-6, 1e-9


def _tree(seed, scale=1.0):
    """A params-shaped tree: a (4, 32, 2) grid and two chains."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return {"grid": a(4, 32, 2),
            "mlps": {"density": [a(8, 16), a(16, 5)],
                     "color": [a(7, 12), a(12, 3)]}}


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _close(got, want, **kw):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g.numpy(), np.asarray(w), **kw), got, want)


@pytest.mark.parametrize("sched", ["cosine", "warmup_cosine"])
def test_schedules_match_reference(sched):
    """Steps 0..139 of a 120-step schedule (past its end too), to float32
    rounding: the two backends' float32 cos may differ by an ulp, which
    ``1 + cos`` keeps as an absolute error near the end, so atol is one
    ulp of 1.0 times the base lr."""
    base = 5e-3 if sched == "cosine" else 1e-3
    steps = np.arange(0, 140, dtype=np.int32)
    if sched == "cosine":
        j, t = jopt.cosine_schedule(base, 120), topt.cosine_schedule(base, 120)
    else:
        j = jopt.linear_warmup_cosine(base, 10, 120)
        t = topt.linear_warmup_cosine(base, 10, 120)
    want = np.asarray([np.asarray(j(jnp.asarray(s))) for s in steps])
    got = np.asarray([float(t(int(s))) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-7,
                               atol=base * np.finfo(np.float32).eps)
    assert got.dtype == want.dtype == np.float32


def test_global_norm_and_clip_match_reference():
    g = _tree(0, scale=3.0)
    np.testing.assert_allclose(float(topt.global_norm(_to_torch(g))),
                               float(jopt.global_norm(g)), rtol=RTOL)
    for max_norm in (1.0, 1e3):   # clipped, and left as it is
        jc, jn = jopt.clip_by_global_norm(g, max_norm)
        tc, tn = topt.clip_by_global_norm(_to_torch(g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
        _close(tc, jc, rtol=RTOL, atol=ATOL)
    assert float(topt.global_norm(topt.clip_by_global_norm(
        _to_torch(g), 1.0)[0])) == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("use_master", [False, True])
@pytest.mark.parametrize("lr", [None, 5e-3])
def test_adamw_three_steps_match_reference(weight_decay, use_master, lr):
    """Three updates with different grads, the lr from the config or given
    as a float32 array; params, m, v, master and count alike."""
    jcfg = jopt.AdamWConfig(lr=1e-2, b2=0.99, eps=1e-15,
                            weight_decay=weight_decay, use_master=use_master)
    tcfg = topt.AdamWConfig(lr=1e-2, b2=0.99, eps=1e-15,
                            weight_decay=weight_decay, use_master=use_master)
    jp = _tree(1)
    tp = _to_torch(jp)
    js, ts = jopt.adamw_init(jp, jcfg), topt.adamw_init(tp, tcfg)
    assert sorted(ts) == sorted(js)
    for k in range(3):
        g = _tree(10 + k, scale=0.1)
        jlr = None if lr is None else jnp.float32(lr * (k + 1))
        tlr = None if lr is None else torch.tensor(lr * (k + 1),
                                                   dtype=torch.float32)
        jp, js = jopt.adamw_update(g, js, jp, jcfg, jlr)
        tp, ts = topt.adamw_update(_to_torch(g), ts, tp, tcfg, tlr)
        _close(tp, jp, rtol=RTOL, atol=ATOL)
        for key in ("m", "v") + (("master",) if use_master else ()):
            _close(ts[key], js[key], rtol=RTOL, atol=ATOL)
        assert int(ts["count"]) == int(js["count"]) == k + 1
        assert ts["count"].dtype == torch.int32


def test_adamw_updates_nothing_in_place():
    tcfg = topt.AdamWConfig(use_master=True)
    p = _to_torch(_tree(2))
    before = jax.tree.map(lambda t: t.clone(), p)
    state = topt.adamw_init(p, tcfg)
    topt.adamw_update(_to_torch(_tree(3)), state, p, tcfg)
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
                 p, before)
    assert int(state["count"]) == 0
    assert all(float(t.abs().max()) == 0.0
               for t in topt.tree_leaves(state["m"]))


def test_tree_leaves_walk_jax_order():
    """Dict keys sorted, lists in order: the order jax.tree flattens in,
    which sets the global norm's sum order."""
    t = _tree(4)
    for got, want in zip(topt.tree_leaves(_to_torch(t)), jax.tree.leaves(t)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(topt.tree_leaves(t)) == len(jax.tree.leaves(t)) == 5
