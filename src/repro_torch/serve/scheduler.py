"""Request-lifecycle scheduler: pluggable admission policies
(``repro.serve.scheduler``; host-only, line for line).

The serving engine's admission loop used to be hard-wired FIFO: pop the
queue head, prepare, admit.  This module makes the policy a seam:

  * ``RequestClass`` — the SLO contract a request arrives with: a
    deadline, a ladder of sample-budget tiers (scale factors applied to
    the per-ray probe counts before ``pool.build_layout`` pads and
    budget-sorts), and a shed floor (the deepest tier load-shedding may
    degrade it to).  ``DEFAULT_CLASS`` has no deadline and a single
    full-budget tier — requests that never mention a class behave
    exactly as before.
  * ``FifoPolicy`` — the default: admit ARRIVED requests in queue order.
    With every request at ``arrival_s == 0`` (the closed-loop tests and
    benches) the operation sequence is bit-identical to the pre-policy
    engine: same pops, same spans, same commits, same counters.
  * ``DeadlinePolicy`` — EDF slot draining: among arrived requests,
    admit the one with the earliest absolute deadline
    (``arrival_s + deadline_ms``); ties resolve to the lowest queue
    position, so ordering is deterministic under equal deadlines.
  * ``ShedPolicy`` — EDF plus load-shedding: when the admission stall a
    request already absorbed has eaten into its deadline slack, degrade
    its budget tier (never below ``shed_floor``) instead of letting it
    queue into a miss.  The projection is the EWMA of recent service
    times scaled by the candidate tier's budget factor.

Degrade points (the bit-identity contract):

  * ``budget_scale_for`` is consulted by Stage-A ``prepare`` — a
    degraded request's layout is built with scaled per-ray counts, so
    the pool's budget-sorted batching and in-batch dedup see the
    degraded budgets natively (scenecache keys include budgets: a
    degraded block can never false-share a full-budget entry).
  * ``admission.admit`` re-prepares when the scheduler degraded a
    request AFTER its speculation ran (``Prepared.tier`` mismatch) —
    Stage A is re-preparable, counted in ``shed_reprepares``, still
    pre-commit.
  * Commits stay on the engine thread in admission order.  Policies
    reorder WHICH request is admitted next and at WHAT tier; they never
    touch the commit path, so FIFO stays bit-identical and the other
    policies keep every cache-coherence invariant.

Scheduler state (service-time EWMA) lives for the engine lifetime;
per-``render()`` state (queue, enqueue clock) is passed per call.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import List, Optional, Tuple

from ..obs import trace as trace_lib


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """The SLO contract of a request: deadline, budget ladder, floor.

    ``tiers`` are sample-budget scale factors, best first; ``tier``
    indexes the starting rung and ``shed_floor`` the deepest rung
    shedding may reach (``<= tier`` disables degradation).  Deadlines
    are relative to the request's ``arrival_s``; ``inf`` means "no
    deadline" and is never shed.
    """
    name: str = "default"
    deadline_ms: float = float("inf")
    tiers: Tuple[float, ...] = (1.0,)
    tier: int = 0
    shed_floor: int = 0

    def deadline_at(self, arrival_s: float) -> float:
        """Absolute deadline on the enqueue-relative clock."""
        return arrival_s + self.deadline_ms * 1e-3


DEFAULT_CLASS = RequestClass()


def budget_scale_for(req) -> float:
    """The sample-budget scale of a request's CURRENT tier (1.0 for the
    default class — callers skip the scaling ops entirely then)."""
    tiers = req.cls.tiers
    return tiers[min(req.tier, len(tiers) - 1)]


# --------------------------------------------------------------- policies
@dataclasses.dataclass(frozen=True)
class FifoPolicy:
    """Arrived requests in queue order — the bit-identical default."""
    shed = False

    def select(self, queue, now_rel: float) -> Optional[int]:
        """Index of the next request to admit among ARRIVED ones (their
        ``arrival_s`` has passed on the enqueue-relative clock), or None
        when nothing has arrived yet."""
        for i, r in enumerate(queue):
            if r.arrival_s <= now_rel:
                return i
        return None

    def prefetch_order(self, queue, now_rel: float) -> List:
        """Arrived requests in the order speculation should run."""
        return [r for r in queue if r.arrival_s <= now_rel]


@dataclasses.dataclass(frozen=True)
class DeadlinePolicy(FifoPolicy):
    """EDF slot draining: earliest absolute deadline first; ties (equal
    deadlines, including the no-deadline default class) resolve to the
    lowest queue position — deterministic for any queue content."""

    def select(self, queue, now_rel: float) -> Optional[int]:
        best = best_key = None
        for i, r in enumerate(queue):
            if r.arrival_s > now_rel:
                continue
            key = (r.cls.deadline_at(r.arrival_s), i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def prefetch_order(self, queue, now_rel: float) -> List:
        arrived = [(r.cls.deadline_at(r.arrival_s), i, r)
                   for i, r in enumerate(queue) if r.arrival_s <= now_rel]
        arrived.sort(key=lambda t: t[:2])
        return [r for _, _, r in arrived]


@dataclasses.dataclass(frozen=True)
class ShedPolicy(DeadlinePolicy):
    """EDF + load-shedding: degrade the budget tier of a request whose
    remaining deadline slack no longer covers its projected service
    time, instead of queueing it into a certain miss.  ``headroom``
    scales the projection (>1 sheds earlier, <1 later)."""
    headroom: float = 1.0
    shed = True


def make_policy(spec) -> FifoPolicy:
    """Resolve a policy spec: None -> FIFO, a name ('fifo'/'edf'/'shed'),
    or a policy instance passed through."""
    if spec is None:
        return FifoPolicy()
    if isinstance(spec, str):
        try:
            return {"fifo": FifoPolicy, "edf": DeadlinePolicy,
                    "shed": ShedPolicy}[spec]()
        except KeyError:
            raise ValueError(f"unknown scheduler policy: {spec!r}")
    return spec


# -------------------------------------------------------------- scheduler
class Scheduler:
    """The engine's admission driver: owns request selection, arrival
    gating (open-loop traffic), shed/degrade decisions, and Stage-A
    prefetch candidate selection.  One per engine, living across
    ``render()`` calls (the service-time EWMA is cross-call state).
    """

    #: EWMA weight of the newest normalized service-time sample.
    EWMA_ALPHA = 0.2

    def __init__(self, policy, counters, metrics=None):
        self.policy = make_policy(policy)
        self.counters = counters
        self.metrics = metrics
        # EWMA of FULL-BUDGET-equivalent service seconds (admission ->
        # finalize, divided by the served tier's scale): the projection
        # basis for shed decisions.  0.0 until the first finalize — no
        # sample means no projection, so nothing sheds on a cold engine.
        self.ewma_service_s = 0.0

    # ------------------------------------------------------- admission
    def admit_ready(self, engine, queue, live, pool, ex, t_enqueue):
        """Fill free slots from the queue per the policy.  Blocks only
        for Stage-A work of the admitted request (exactly the pre-policy
        loop) or — open-loop traffic, nothing live yet — until the next
        arrival.  Mutates ``queue``/``live``/``pool`` in place."""
        from . import admission
        rcfg = engine.rcfg
        self._observe_depth(ex)
        while queue and len(live) < rcfg.slots:
            now_rel = time.time() - t_enqueue
            idx = self.policy.select(queue, now_rel)
            if idx is None:
                if live:
                    break              # march what's live; arrivals later
                self._sleep_until_arrival(queue, t_enqueue)
                continue
            req = queue.pop(idx)
            if self.policy.shed:
                self._maybe_shed(req, now_rel - req.arrival_s)
            t0 = time.time()
            # admission.wait covers the BLOCKING admission window
            # (take/steal + inline Stage A + Stage B) — the flight
            # recorder's stall trigger watches this span
            with trace_lib.span("admission.wait", req=req.rid,
                                scene=req.scene):
                prepared = ex.take(id(req))
                speculated = prepared is not None
                if prepared is None:  # never speculated: A inline
                    prepared = admission.prepare(engine, req)
                slot = admission.admit(
                    engine, req, prepared,
                    t_enqueue=t_enqueue + req.arrival_s)
            # blocking admission time; speculated Stage-A work adds
            # its (overlapped) duration to admission_s only
            slot.admit_stall_s = time.time() - t0
            slot.admission_s = slot.admit_stall_s + (
                prepared.prep_s if speculated else 0.0)
            slot.t_admit = t0
            live.append(slot)
            pool.add_slot(slot)

    def speculate(self, engine, queue, live, ex, t_enqueue):
        """Submit Stage-A speculation for up to ``prefetch`` queued
        requests, in policy order over the ARRIVED ones (clamped: a
        negative prefetch must mean "off", not a near-full slice).

        Under a shedding policy the degrade decision runs HERE first,
        against the PROJECTED admission stall (wait so far + slots
        occupied/queued ahead, each a projected service time), so the
        speculated layout is usually built at the tier the request will
        be admitted at — admission re-degrades only when the projection
        was optimistic, and then rebuilds just the layout."""
        from . import admission
        rcfg = engine.rcfg
        n = max(rcfg.prefetch, 0)
        if n == 0 or not queue:
            return
        now_rel = time.time() - t_enqueue
        ordered = self.policy.prefetch_order(queue, now_rel)[:n]
        for pos, req in enumerate(ordered):
            if self.policy.shed:
                ahead = len(live) + pos
                projected = (now_rel - req.arrival_s
                             + ahead * self.ewma_service_s
                             / max(rcfg.slots, 1))
                self._maybe_shed(req, projected)
            ex.submit(id(req), partial(admission.prepare, engine, req))

    def note_finalized(self, slot):
        """Fold one finished request's service time (admission start ->
        finalize, normalized to full budget) into the EWMA — the shed
        projection basis.  Per-class ledgers live in stats.py."""
        req = slot.req
        t_admit = getattr(slot, "t_admit", None)
        if t_admit is not None:
            norm = (time.time() - t_admit) / max(budget_scale_for(req),
                                                 1e-6)
            if self.ewma_service_s == 0.0:
                self.ewma_service_s = norm
            else:
                a = self.EWMA_ALPHA
                self.ewma_service_s = a * norm + (1 - a) * self.ewma_service_s

    # ----------------------------------------------------------- internals
    def _maybe_shed(self, req, waited_s: float):
        """Degrade ``req``'s tier while the deadline slack left after the
        stall it already absorbed cannot cover the projected service time
        at the current tier.  Stops at the class's shed floor (a floored
        request may still miss; that is counted, never dropped)."""
        cls = req.cls
        est = self.ewma_service_s * self.policy.headroom
        if est <= 0.0 or cls.deadline_ms == float("inf"):
            return
        slack = cls.deadline_ms * 1e-3 - waited_s
        while (req.tier < cls.shed_floor
               and est * cls.tiers[req.tier] > slack):
            req.tier += 1
            req.degrades += 1
            self.counters.shed_degrades += 1
            trace_lib.instant("scheduler.shed", req=req.rid, cls=cls.name,
                              tier=req.tier, waited_ms=waited_s * 1e3)

    def _sleep_until_arrival(self, queue, t_enqueue):
        """Open-loop gap: nothing live, nothing arrived — sleep until the
        earliest queued arrival."""
        gap = min(r.arrival_s for r in queue) + t_enqueue - time.time()
        if gap > 0:
            with trace_lib.span("scheduler.idle", gap_ms=gap * 1e3):
                time.sleep(gap)

    def _observe_depth(self, ex):
        """Publish the executor's speculation queue depth as gauges so
        stall projections are observable next to the latency series."""
        if self.metrics is None:
            return
        depth = getattr(ex, "depth", None)
        if depth is None:
            return
        d = depth()
        self.metrics.gauge("executor_pending_depth").set(d["pending"])
        self.metrics.gauge("executor_inflight_depth").set(d["inflight"])
