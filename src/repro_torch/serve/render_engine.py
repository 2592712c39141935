"""Batched multi-view render serving engine — the pipeline facade
(``repro.serve.render_engine``).

Render requests (camera pose + scene) occupy ``slots``; every scheduling
round the Phase-II blocks of ALL live requests are pooled, sorted by
sample budget, and marched as one fixed-size batch — with a kernel field
(``kernels.ops.field_fns``) and ``march_backend="fused"``, one
``fused_march`` launch — continuous batching for rays.  Cross-frame
reuse goes through ``framecache`` (warped probe maps, warped radiance),
cross-user block reuse through ``scenecache``.  The engine runs on
``device``: the GPU unless the caller passes ``device="cpu"``.

This module is deliberately SMALL (a test fails if it regrows past 250
lines): it owns only the scheduling loop and the public surface.  The
pipeline lives in four layers:

  * ``admission``  — Stage-A speculation (plans + probe/warp device work
    + pad/sort layout) and the Stage-B commit (revalidate, book, slot);
  * ``pool``       — block pooling, batch assembly, in-batch dedup,
    scene-store delivery;
  * ``executor``   — WHERE Stage A executes: inline (the bit-identical
    default), on worker threads with a CUDA stream each, or placed on
    secondary cards — the threaded backends overlap probe device time
    with the in-flight march on the engine's stream;
  * ``stats``      — counters and aggregate reporting.

Invariant spanning all layers: speculation (any thread, any depth) only
moves device work earlier — commits happen on the engine thread in
admission order, so rendered frames and the deterministic counters are
bit-identical at every ``prefetch`` depth and ``workers`` count.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from ..core.fields import FieldFns
from ..core.pipeline import ASDRConfig
from ..framecache.probe import ProbeCache, ProbeMaps, ProbeReuseConfig
from ..framecache.radiance import RadianceCache, RadianceReuseConfig
from ..device import resolve_device
from ..obs import Registry, engine_tracer, trace as trace_lib
from ..scenecache import SceneBlockCache
from . import admission, executor as executor_lib, pool as pool_lib
from . import scheduler as scheduler_lib
from . import stats as stats_lib
from .admission import RenderRequest, RenderServeConfig  # noqa: F401
from .scheduler import (DEFAULT_CLASS, DeadlinePolicy,  # noqa: F401
                        FifoPolicy, RequestClass, ShedPolicy)

__all__ = ["RenderRequest", "RenderServeConfig", "RenderServingEngine",
           "ProbeReuseConfig", "RadianceReuseConfig", "ProbeMaps",
           "RequestClass", "DEFAULT_CLASS", "FifoPolicy", "DeadlinePolicy",
           "ShedPolicy"]


class RenderServingEngine:
    def __init__(self, fields: Dict[str, FieldFns], acfg: ASDRConfig,
                 rcfg: RenderServeConfig = RenderServeConfig(),
                 scenecache: Optional[SceneBlockCache] = None,
                 device=None):
        self.fields = fields
        self.acfg = acfg
        self.rcfg = rcfg
        self.device = resolve_device(device)
        self.probe_caches: Dict[str, ProbeCache] = {
            name: ProbeCache(rcfg.reuse) for name in fields
        } if rcfg.reuse is not None else {}
        self.radiance_caches: Dict[str, RadianceCache] = {
            name: RadianceCache(rcfg.radiance) for name in fields
        } if rcfg.radiance is not None else {}
        # scene-space block store: an explicitly passed instance is SHARED
        # (several engines over one scene pool their hits); otherwise the
        # engine owns one iff the config asks for it.  Keys carry the
        # scene id, so one store safely serves all of this engine's scenes.
        if scenecache is None and rcfg.scenecache is not None:
            scenecache = SceneBlockCache(rcfg.scenecache)
        self.scenecache = scenecache
        # engine counters (across render() calls) — see serve/stats.py
        self.counters = stats_lib.EngineCounters()
        # observability: the metrics registry always exists (engine_stats
        # reads through it); the tracer only when rcfg.trace asks — None
        # keeps every instrumented call site on the null-span fast path
        self.metrics = Registry()
        self.tracer = engine_tracer(rcfg.trace, self.metrics)
        self._rounds = 0
        self.executor = executor_lib.make_executor(
            rcfg.workers, rcfg.devices, device=self.device)
        # request-lifecycle scheduler (serve/scheduler.py): owns request
        # selection, open-loop arrival gating, and shed/degrade
        # decisions; rcfg.policy None/"fifo" is bit-identical FIFO
        self.scheduler = scheduler_lib.Scheduler(rcfg.policy, self.counters,
                                                 metrics=self.metrics)

    # counter back-compat: eng.blocks_marched etc. read through to the
    # stats layer (only consulted when normal attribute lookup fails)
    def __getattr__(self, name):
        if name in stats_lib.COUNTER_FIELDS:
            return getattr(self.counters, name)
        raise AttributeError(name)

    def close(self):
        """Release executor workers; flush + uninstall the tracer."""
        self.executor.close()
        if self.tracer is not None:
            tcfg = self.rcfg.trace
            if tcfg.metrics_jsonl:     # closing-state snapshot, so short
                self.engine_stats()    # runs still get >= 1 line
                self.metrics.jsonl_snapshot(
                    tcfg.metrics_jsonl,
                    extra={"round": self._rounds, "final": True})
            self.tracer.finish()       # final drain + configured exports
            trace_lib.uninstall(self.tracer)
            self.tracer = None

    def _probe_key(self, req: RenderRequest):
        return admission.probe_jitter_for(self.rcfg, req, self.acfg,
                                          self.device)

    def _march_for(self, scene_id: str, density_only: bool = False):
        return pool_lib.batched_march(self.fields[scene_id], self.acfg,
                                      density_only)

    # ---------------------------------------------------------------- serve
    def render(self, requests: List[RenderRequest]) -> List[RenderRequest]:
        """Serve all requests; returns them completed, in finish order.

        Continuous batching: undispatched blocks from every live request
        sit in one budget-sorted pool; each round marches ONE fixed-size
        batch drawn from the pool's largest-budget scene group, then
        finalizes any request whose blocks all returned and admits queued
        requests into freed slots — so new requests enter while older
        ones are still mid-flight, and a batch freely mixes blocks from
        different requests of the same scene.  A radiance-warped frame
        with no disoccluded rays contributes zero blocks and finalizes on
        the round it was admitted.

        Double buffering: after the round's march batch is DISPATCHED
        (async on device) and before its outputs are fetched, Stage A is
        speculated for up to ``prefetch`` queued requests — inline here
        (sync executor) or on worker threads — so probing/warping of
        queued requests overlaps marching of live ones, and admission
        consumes the prepared work with only the commit left to do.
        """
        rcfg = self.rcfg
        t_enqueue = time.time()    # latency clock: queue wait counts
        queue = list(requests)
        live: List[admission.Slot] = []
        done: List[RenderRequest] = []
        pool = pool_lib.BlockPool(self.acfg, rcfg.blocks_per_batch,
                                  self.scenecache, self.counters)
        ex = self.executor
        try:
            return self._serve(queue, live, done, pool, ex, t_enqueue)
        finally:
            # speculation keys are id(request): they must never survive
            # this call (a later call's request can reuse a freed id,
            # and a mid-call exception would otherwise strand results)
            ex.reset()

    def _serve(self, queue, live, done, pool, ex, t_enqueue):
        rcfg = self.rcfg
        sched = self.scheduler
        while queue or live:
            # admission per the scheduler policy: FIFO by default (the
            # bit-identical pre-scheduler loop), EDF/shed opt-in — see
            # serve/scheduler.py for the selection/degrade contract
            sched.admit_ready(self, queue, live, pool, ex, t_enqueue)

            pool.sweep()
            # streaming dispatch: up to inflight_batches batches launch
            # back-to-back (next group fills idle launches), ALL in
            # flight before any collect — see pool.dispatch_round
            t_march = time.time()
            inflights = pool.dispatch_round(
                self._march_for, max(rcfg.inflight_batches, 1))

            # Stage-A prefetch: speculate admissions for the policy's
            # next arrived requests while the round is in flight
            sched.speculate(self, queue, live, ex, t_enqueue)

            for inflight in inflights:
                pool.collect(inflight)
            if inflights:
                self.counters.note_round(time.time() - t_march,
                                         len(inflights))

            still = []
            for slot in live:
                if slot.pending == 0:
                    done.append(self._finalize(slot))
                else:
                    still.append(slot)
            live = still
            if self.tracer is not None:
                self._obs_round()
        return done

    def _obs_round(self):
        """Per-round observability housekeeping (tracing on only):
        drain thread buffers into the tracer store / flight recorder /
        span histograms, and emit a periodic metrics JSONL snapshot."""
        self.tracer.drain()
        tcfg = self.rcfg.trace
        self._rounds += 1
        if (tcfg.metrics_jsonl
                and self._rounds % max(tcfg.metrics_every, 1) == 0):
            self.engine_stats()        # refresh the registry gauges
            self.metrics.jsonl_snapshot(tcfg.metrics_jsonl,
                                        extra={"round": self._rounds})

    def _finalize(self, slot: admission.Slot) -> RenderRequest:
        req = slot.finalize(self.acfg)
        self.counters.note_finalized(req.stats, req.latency_s)
        self.scheduler.note_finalized(slot)   # service-time EWMA feed
        # only frames with full marched acc/depth feed the radiance cache
        # (framecache safety invariant: warps never chain) — that means
        # fully-rendered frames, plus density-REFRESHED warped frames
        # (opt-in), whose warp-valid rays re-marched acc/depth through
        # the color-free path.  The stored depth is the MARCH's per-ray
        # termination depth — always pose-aligned (so even dilation-mode
        # probe-reuse frames, whose probe maps carry depth=None, are
        # cacheable) and sharper than the probe's stride-d proxy.
        rad = self.radiance_caches.get(req.scene)
        if rad is not None and slot.acc_full is not None:
            R = req.cam.height * req.cam.width
            dev = self.device
            rad.store(req.cam, self.acfg,
                      torch.tensor(req.image.reshape(R, 3), device=dev),
                      torch.tensor(slot.acc_full, device=dev),
                      torch.tensor(slot.depth_full, device=dev))
        return req

    # ---------------------------------------------------------------- stats
    def engine_stats(self) -> Dict:
        return stats_lib.engine_stats(self.counters, self.probe_caches,
                                      self.radiance_caches, self.scenecache,
                                      registry=self.metrics)
