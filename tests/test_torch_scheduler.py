"""Port parity and properties: the request-lifecycle scheduler
(serve/scheduler.py).

FIFO bit-identity across executors x prefetch and against the JAX engine;
EDF order under deadline ties (unit and engine level, against the
reference's); the shed property that a request's tier never passes its
class's floor, and the engine-level accounting (shed + full == frames)
against the reference's; open-loop arrival gating; policy resolution;
budget-scaled counts equal to the reference's; the executor depth
gauges.
"""
import dataclasses
import math
import time

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serve import pool as jpool
from repro.serve import scheduler as jsched
from repro.serve.admission import RenderRequest as JRequest
from repro.serve.stats import EngineCounters as JCounters
from repro_torch.serve import executor as executor_lib
from repro_torch.serve import pool as tpool
from repro_torch.serve import render_engine as tre
from repro_torch.serve.render_engine import (DeadlinePolicy, FifoPolicy,
                                             RequestClass, ShedPolicy)
from repro_torch.serve.scheduler import (Scheduler, budget_scale_for,
                                         make_policy)
from repro_torch.serve.stats import DETERMINISTIC_COUNTERS, EngineCounters
from test_torch_render_serve import (acfgs, assert_parity, field_pairs,
                                     requests, run_both, serve_cfgs)

REPLAY = dict(slots=2, blocks_per_batch=4, reuse=dict(refresh_every=0),
              radiance=dict(refresh_every=0))


def replay_spec(n=8):
    return [(i, "mic", 0.7 + 0.05 * (i % 3), 0.5) for i in range(n)]


def port_engine(rcfg):
    return tre.RenderServingEngine({"mic": field_pairs()["mic"][1]},
                                   acfgs()[1], rcfg, device="cpu")


def _req(rid, cls=None, arrival=0.0, theta=0.7):
    req = requests([(rid, "mic", theta, 0.5)])[1][0]
    return dataclasses.replace(req, arrival_s=arrival,
                               **({"cls": cls, "tier": -1}
                                  if cls is not None else {}))


# ----------------------------------------------------------- bit-identity
def test_fifo_policy_bit_identity():
    """policy=None, 'fifo' and FifoPolicy() give the same frames and
    deterministic counters at every executor x prefetch, equal to the
    JAX engine's FIFO run."""
    cases = [
        ("none-sync-p0", None, dict(workers=0, prefetch=0)),
        ("none-threaded-p2", None, dict(workers=2, prefetch=2)),
        ("name-sync-p2", "fifo", dict(workers=0, prefetch=2)),
        ("inst-threaded-p0", FifoPolicy(), dict(workers=2, prefetch=0)),
        ("inst-device-p2", FifoPolicy(), dict(workers=0, prefetch=2,
                                              devices=2)),
    ]
    runs = {}
    for label, policy, kw in cases:
        eng = port_engine(serve_cfgs(policy=policy, **REPLAY, **kw)[1])
        done = {r.rid: r for r in eng.render(requests(replay_spec())[1])}
        runs[label] = (done, eng.engine_stats())
        eng.close()
    done_j, done_t, st_j, st_t = run_both(replay_spec(), prefetch=0, **REPLAY)
    assert_parity(done_j, done_t, st_j, st_t)
    ref_done, ref_st = runs["none-sync-p0"]
    for label, (done, st_) in runs.items():
        for rid in ref_done:
            np.testing.assert_array_equal(ref_done[rid].image,
                                          done[rid].image, err_msg=label)
        for c in DETERMINISTIC_COUNTERS:
            assert ref_st[c] == st_[c] == st_t[c], (label, c)
    assert ref_st["requests_shed"] == 0
    assert ref_st["requests_full"] == ref_st["frames"]


# ------------------------------------------------------------ EDF ordering
def test_edf_select_deadline_order_and_ties():
    """Earliest absolute deadline wins; equal deadlines resolve to the
    lowest queue position; un-arrived requests are invisible — the same
    picks as the reference's policy."""
    pol, jpol = DeadlinePolicy(), jsched.DeadlinePolicy()
    rt50 = RequestClass("rt50", deadline_ms=50.0)
    rt10 = RequestClass("rt10", deadline_ms=10.0)
    q = [_req(0), _req(1, rt50), _req(2, rt10), _req(3, rt50)]
    assert pol.select(q, now_rel=0.0) == 2 == jpol.select(q, 0.0)
    assert [r.rid for r in pol.prefetch_order(q, 0.0)] == [2, 1, 3, 0]
    q_tie = [_req(0, rt50), _req(1, rt50), _req(2, rt50)]
    assert pol.select(q_tie, 0.0) == 0
    assert [r.rid for r in pol.prefetch_order(q_tie, 0.0)] == [0, 1, 2]
    q_fut = [_req(0, rt10, arrival=0.02), _req(1, rt50)]
    assert pol.select(q_fut, 0.0) == 1
    assert pol.select(q_fut, 0.025) == 0
    q_late = [_req(0, rt10, arrival=5.0), _req(1, rt50)]
    assert pol.select(q_late, 6.0) == 1 == jpol.select(q_late, 6.0)
    assert pol.select([_req(0, arrival=1.0)], 0.0) is None


def test_edf_engine_admission_order():
    """Engine-level EDF with slots=1 drains strictly by (deadline, queue
    position), as the reference's engine does, and reordering never
    changes frame bytes (caches off)."""
    spec = [(0, "mic", 0.55, 0.5), (1, "mic", 0.65, 0.5),
            (2, "mic", 0.75, 0.5), (3, "mic", 0.85, 0.5)]
    classes = {1: dict(name="rt20", deadline_ms=20.0),
               2: dict(name="rt20", deadline_ms=20.0),
               3: dict(name="rt5", deadline_ms=5.0)}
    kw = dict(slots=1, blocks_per_batch=4, reuse=None, radiance=None,
              prefetch=0)
    done_j, done_t, st_j, st_t = run_both(spec, classes=classes,
                                          policy="edf", **kw)
    assert [r.rid for r in done_t] == [3, 1, 2, 0]
    assert_parity(done_j, done_t, st_j, st_t)
    eng_f = port_engine(serve_cfgs(**kw)[1])
    ref = {r.rid: r for r in eng_f.render(requests(spec)[1])}
    eng_f.close()
    for r in done_t:
        np.testing.assert_array_equal(r.image, ref[r.rid].image)


# ------------------------------------------------------------ shed property
@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=0, max_value=3),
       st.floats(min_value=0.0, max_value=0.2),
       st.floats(min_value=1.0, max_value=400.0),
       st.floats(min_value=0.0, max_value=0.5))
def test_shed_never_degrades_past_floor(floor, ewma, deadline_ms, waited):
    """Whatever the projected service time, realized wait and deadline,
    ``_maybe_shed`` never takes a request past its class's shed floor,
    every step is accounted, and the tier reached is the reference's."""
    tiers = (1.0, 0.5, 0.25, 0.125)
    cls = RequestClass("rt", deadline_ms=deadline_ms, tiers=tiers,
                       shed_floor=floor)
    counters = EngineCounters()
    sched = Scheduler("shed", counters)
    sched.ewma_service_s = ewma
    req = tre.RenderRequest(rid=0, scene="mic", cam=None, cls=cls)
    assert req.tier == 0
    sched._maybe_shed(req, waited)
    assert 0 <= req.tier <= cls.shed_floor
    assert budget_scale_for(req) >= cls.tiers[cls.shed_floor]
    assert req.degrades == req.tier
    assert counters.shed_degrades == req.degrades
    jcls = jsched.RequestClass("rt", deadline_ms=deadline_ms, tiers=tiers,
                               shed_floor=floor)
    jreq = JRequest(rid=0, scene="mic", cam=None, cls=jcls)
    jsched_ = jsched.Scheduler("shed", JCounters())
    jsched_.ewma_service_s = ewma
    jsched_._maybe_shed(jreq, waited)
    assert jreq.tier == req.tier
    for quiet_cls in (cls, dataclasses.replace(cls, deadline_ms=math.inf)):
        quiet = tre.RenderRequest(rid=1, scene="mic", cam=None, cls=quiet_cls)
        cold = Scheduler("shed", EngineCounters())
        cold.ewma_service_s = 0.0 if quiet_cls is cls else ewma
        cold._maybe_shed(quiet, waited)
        assert quiet.tier == 0 and quiet.degrades == 0


def test_shed_accounting_and_class_stats():
    """A warmed EWMA plus an impossible 5 ms deadline sheds every rt
    request exactly to the floor tier, ``requests_shed + requests_full ==
    frames``, and the degraded frames equal the reference engine's."""
    spec = [(0, "mic", 0.55, 0.5)] + [(i, "mic", 0.55 + 0.1 * i, 0.5)
                                      for i in range(1, 6)]
    classes = {0: dict(name="warm", deadline_ms=1.0)}
    classes.update({i: dict(name="rt", deadline_ms=5.0,
                            tiers=(1.0, 0.5, 0.25), shed_floor=2)
                    for i in range(1, 6)})
    done_j, done_t, st_j, st_out = run_both(
        spec, classes=classes, slots=1, blocks_per_batch=4, reuse=None,
        radiance=None, prefetch=0, policy="shed")
    assert_parity(done_j, done_t, st_j, st_out)
    assert st_out["frames"] == 6
    assert st_out["requests_shed"] + st_out["requests_full"] \
        == st_out["frames"]
    assert st_out["requests_shed"] == 5
    assert st_out["shed_degrades"] == 10
    for r in done_t:
        if r.cls.name == "rt":
            assert r.tier == r.cls.shed_floor
            assert budget_scale_for(r) == r.cls.tiers[r.cls.shed_floor]
        else:
            assert r.tier == 0 and r.degrades == 0
    assert set(st_out["class_stats"]) == {"rt", "warm"}
    led = st_out["class_stats"]["rt"]
    assert led["frames"] == 5 and led["shed"] == 5
    assert st_out["deadline_misses"] >= led["deadline_misses"]


# -------------------------------------------------------- open-loop traffic
def test_open_loop_arrival_gating():
    """A queued request is invisible until its ``arrival_s`` passes, and
    its latency clock starts at the arrival."""
    eng = port_engine(tre.RenderServeConfig(slots=2, blocks_per_batch=4,
                                            reuse=None, radiance=None,
                                            prefetch=0))
    eng.render([_req(0)])
    t0 = time.time()
    done = eng.render([_req(1), _req(2, arrival=0.4, theta=0.75)])
    wall = time.time() - t0
    eng.close()
    assert [r.rid for r in done] == [1, 2]
    assert wall >= 0.4
    assert done[1].latency_s <= wall - 0.35


# ----------------------------------------------------------------- plumbing
def test_make_policy_resolution():
    assert type(make_policy(None)) is FifoPolicy
    assert not make_policy(None).shed
    assert type(make_policy("fifo")) is FifoPolicy
    assert type(make_policy("edf")) is DeadlinePolicy
    pol = make_policy("shed")
    assert type(pol) is ShedPolicy and pol.shed and pol.headroom == 1.0
    mine = ShedPolicy(headroom=2.0)
    assert make_policy(mine) is mine
    with pytest.raises(ValueError):
        make_policy("lifo")


def test_budget_scaled_counts_match_reference():
    """Scaled counts round UP, never below one sample per ray, as the
    reference's; scale 1.0 is the identity on positive counts."""
    import torch
    vals = [0, 1, 2, 7, 48, 96, 13]
    for scale in (0.25, 0.5, 0.125, 1.0):
        got = tpool._scale_counts(torch.tensor(vals, dtype=torch.int32),
                                  scale)
        want = np.asarray(jpool._scale_counts(jnp.array(vals, jnp.int32),
                                              scale))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        tpool._scale_counts(torch.tensor(vals[1:]), 1.0).numpy(), vals[1:])


def test_executor_depth_gauges():
    """Every executor reports queue depth, and the scheduler publishes it
    through the metrics registry during admission."""
    ex = executor_lib.SyncExecutor()
    assert ex.depth() == {"pending": 0, "inflight": 0}
    ex.submit("k", lambda: 1)
    assert ex.depth()["pending"] == 1
    ex.take("k")
    assert ex.depth()["pending"] == 0
    ex.close()

    ex = executor_lib.ThreadedExecutor(2, device="cpu")
    ex.submit("a", lambda: time.sleep(0.02) or 1)
    d = ex.depth()
    assert d["pending"] >= 1 and d["inflight"] >= 0
    assert ex.take("a") == 1
    assert ex.depth()["pending"] == 0
    ex.close()

    eng = port_engine(serve_cfgs(prefetch=2, **REPLAY)[1])
    eng.render(requests(replay_spec(3))[1])
    snap = eng.metrics.snapshot()
    eng.close()
    assert "executor_pending_depth" in snap
    assert "executor_inflight_depth" in snap
