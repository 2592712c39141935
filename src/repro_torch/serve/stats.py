"""Counters and aggregate reporting — the serving pipeline's ledger layer
(``repro.serve.stats``).

Every number the engine exposes lives in one of two places:

  * ``EngineCounters`` — plain integers plus BOUNDED timing ledgers
    accumulated across ``render()`` calls.  Mutated ONLY on the engine
    thread (admission commits and batch collection), so they need no
    lock and stay deterministic at every prefetch depth and worker
    count — the executor determinism tests gate on them.
    ``misprepares`` is the single deliberate exception to cross-config
    determinism: it counts speculation that aged out between Stage A
    and commit, which depends on speculation TIMING (prefetch depth,
    worker scheduling) by design.
  * per-cache ledgers (probe/radiance/scenecache) — owned by the caches
    themselves; ``engine_stats`` only reads them.

Timing ledgers (march_ms, latency_ms, admit_stall_ms) are
``obs.metrics.Series`` ring buffers — a long-running engine holds at
most ``SERIES_CAPACITY`` samples per series instead of an unbounded
list (the pre-obs leak), while p50/p99 keep their semantics over the
recent window.  ``batches_per_round`` is a Counter keyed by batch count
(bounded by the distinct counts seen, i.e. by ``inflight_batches``).

This module owns the invariant arithmetic: probe hits + misses + skips
== admissions, reused fractions, pad fractions, the samples split.
``engine_stats`` publishes every key into an ``obs.metrics.Registry``
when one is passed (the engine's), and the returned dict is then a READ
of that registry — same keys, same values, but also available as
Prometheus exposition and periodic JSONL snapshots.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Optional

from ..kernels import ops as kernel_ops
from ..obs import metrics as obs_metrics
from ..obs.metrics import percentile as _percentile  # noqa: F401 (compat)

# ring capacity of the per-engine timing series: enough to hold every
# round of any bench/test run exactly, O(1) for a long-running engine
SERIES_CAPACITY = 4096


def _series():
    return obs_metrics.Series(SERIES_CAPACITY)


@dataclasses.dataclass
class ClassLedger:
    """Per-RequestClass slice of the finalize ledger (scheduler tier):
    frame count, shed/deadline accounting, and a bounded latency series
    so ``engine_stats`` reports p50/p99 PER CLASS — the number the SLO
    bench gates (a deadline class's tail must not hide in the global
    percentile next to bulk traffic)."""
    frames: int = 0
    shed: int = 0                 # frames served at a degraded tier
    deadline_misses: int = 0
    latency_ms: obs_metrics.Series = dataclasses.field(
        default_factory=_series)

    def stats(self) -> Dict:
        return {"frames": self.frames, "shed": self.shed,
                "deadline_misses": self.deadline_misses,
                "latency_ms_p50": self.latency_ms.percentile(50.0),
                "latency_ms_p99": self.latency_ms.percentile(99.0)}


@dataclasses.dataclass
class EngineCounters:
    """Engine-thread-only counters, accumulated across render() calls."""
    frames: int = 0
    batches: int = 0
    blocks_marched: int = 0
    pad_blocks: int = 0
    rays_marched: int = 0
    rays_total: int = 0
    scene_blocks_hit: int = 0
    admissions: int = 0
    full_radiance_hits: int = 0   # admissions that skipped Phase I
    misprepares: int = 0          # speculated Stage-A work discarded
    # request-lifecycle scheduler accounting (serve/scheduler.py).  Like
    # misprepares, all four depend on admission-stall TIMING under a
    # shedding policy and are deliberately NOT in DETERMINISTIC_COUNTERS
    # (FIFO keeps them at zero).  Invariant the property tests gate:
    # requests_shed + requests_full == frames — shedding degrades, it
    # never drops.
    shed_degrades: int = 0        # tier steps the scheduler applied
    shed_reprepares: int = 0      # speculation redone after a degrade
    requests_shed: int = 0        # frames served at a degraded tier
    requests_full: int = 0        # frames served at their class tier
    deadline_misses: int = 0
    samples_processed: int = 0
    samples_reused: int = 0
    # sample work the fused march's per-RAY early exit skipped (pool
    # collect, gated on ASDRConfig.per_ray_early_exit): rays whose
    # transmittance saturated before their block's exit chunk stop
    # running the field, chunk-granular.  Stays 0 with the flag off, so
    # it is deliberately NOT in DETERMINISTIC_COUNTERS — it prices an
    # opt-in approximation tier, like the shed counters.
    ray_exit_samples_skipped: int = 0
    # per-round streaming-dispatch observability (engine thread only):
    # wall time of each dispatch_round->collect window and how many
    # batches it launched.  Wall times are TIMING, not scheduling — they
    # are reported as percentiles, never gated for determinism.  Bounded:
    # a Series ring (recent window) and a Counter histogram.
    march_ms: obs_metrics.Series = dataclasses.field(default_factory=_series)
    batches_per_round: Counter = dataclasses.field(default_factory=Counter)
    # per-request end-to-end ledgers, fed at finalize: first-class
    # latency stats instead of every bench re-aggregating RenderRequest
    # fields by hand
    latency_ms: obs_metrics.Series = dataclasses.field(
        default_factory=_series)
    admit_stall_ms: obs_metrics.Series = dataclasses.field(
        default_factory=_series)
    # per-RequestClass slices of the same ledger, keyed by class name
    by_class: Dict[str, ClassLedger] = dataclasses.field(
        default_factory=dict)

    def note_finalized(self, req_stats: Dict, latency_s: float = 0.0):
        """Fold one finalized request's per-frame stats into the ledger."""
        self.frames += 1
        self.rays_marched += req_stats["rays_marched"]
        self.rays_total += req_stats["rays_total"]
        self.samples_processed += req_stats["samples_processed"]
        self.samples_reused += req_stats["samples_reused"]
        self.latency_ms.observe(latency_s * 1e3)
        self.admit_stall_ms.observe(req_stats["admit_stall_s"] * 1e3)
        # scheduler accounting: every frame is either full-tier or shed
        shed = req_stats.get("degrades", 0) > 0
        missed = not req_stats.get("deadline_met", True)
        self.requests_shed += shed
        self.requests_full += not shed
        self.deadline_misses += missed
        led = self.by_class.setdefault(req_stats.get("class", "default"),
                                       ClassLedger())
        led.frames += 1
        led.shed += shed
        led.deadline_misses += missed
        led.latency_ms.observe(latency_s * 1e3)

    def note_round(self, wall_s: float, n_batches: int):
        """Record one dispatch_round->collect window."""
        self.march_ms.observe(wall_s * 1e3)
        self.batches_per_round[n_batches] += 1


COUNTER_FIELDS = frozenset(f.name for f in
                           dataclasses.fields(EngineCounters))

# engine_stats() keys that must be identical across executors at any
# worker count / prefetch depth: everything decided at commit time
# (engine thread, admission order).  ``misprepares`` is deliberately
# absent — it counts speculation that aged out between Stage A and
# commit, which depends on speculation timing by design.  The executor
# determinism tests and the --workers benchmark gate both consume this.
# Tracing on/off must never change any of these either
# (tests/test_obs.py).
DETERMINISTIC_COUNTERS = (
    "frames", "admissions", "probe_hits", "probe_misses", "probe_skips",
    "probe_refreshes", "full_radiance_hits", "radiance_hits",
    "radiance_misses", "rays_marched", "rays_total", "samples_processed",
    "samples_reused", "blocks_marched")


def engine_stats(counters: EngineCounters, probe_caches: Dict,
                 radiance_caches: Dict, scenecache,
                 registry: Optional[obs_metrics.Registry] = None) -> Dict:
    """The engine's aggregate stats dict (the public ``engine_stats()``).

    With a registry, every key is published as a gauge and the returned
    dict is a read-back of those gauges — ``engine_stats()`` IS a
    registry view, and the same numbers flow to the Prometheus text
    exposition and the periodic JSONL snapshots.
    """
    c = counters
    out = {
        "frames": c.frames,
        "batches": c.batches,
        "blocks_marched": c.blocks_marched,
        "pad_block_fraction": (
            c.pad_blocks / max(c.blocks_marched + c.pad_blocks, 1)),
        "rays_marched": c.rays_marched,
        "rays_total": c.rays_total,
        "rays_marched_fraction": c.rays_marched / max(c.rays_total, 1),
        "admissions": c.admissions,
        "full_radiance_hits": c.full_radiance_hits,
        "misprepares": c.misprepares,
        # scheduler tier (serve/scheduler.py): shed/degrade accounting —
        # shed + full == frames (degrade, never drop) — plus per-class
        # frame/latency slices so a deadline class's p99 is gateable
        # next to bulk traffic
        "shed_degrades": c.shed_degrades,
        "shed_reprepares": c.shed_reprepares,
        "requests_shed": c.requests_shed,
        "requests_full": c.requests_full,
        "deadline_misses": c.deadline_misses,
        "class_stats": {name: led.stats()
                        for name, led in sorted(c.by_class.items())},
        "samples_processed": c.samples_processed,
        "samples_reused": c.samples_reused,
        "ray_exit_samples_skipped": c.ray_exit_samples_skipped,
        # streaming-dispatch round observability: march wall-time
        # percentiles + how many batches each round launched (a
        # histogram {n_batches: rounds}); batches_per_round > 1 is the
        # signal that multi-batch rounds actually fill idle launches
        "march_ms_p50": c.march_ms.percentile(50.0),
        "march_ms_p99": c.march_ms.percentile(99.0),
        "march_rounds": c.march_ms.count,
        "batches_per_round": dict(sorted(c.batches_per_round.items())),
        # first-class per-request latency: end-to-end (queue wait +
        # admission + march) and the blocking admission stall, both in
        # ms from the bounded series the finalize path feeds
        "latency_ms_p50": c.latency_ms.percentile(50.0),
        "latency_ms_p99": c.latency_ms.percentile(99.0),
        "admit_stall_ms_p50": c.admit_stall_ms.percentile(50.0),
        "admit_stall_ms_p99": c.admit_stall_ms.percentile(99.0),
    }
    hits = sum(pc.hits for pc in probe_caches.values())
    misses = sum(pc.misses for pc in probe_caches.values())
    skips = sum(pc.skips for pc in probe_caches.values())
    out["probe_hits"] = hits
    out["probe_misses"] = misses
    # skips are admissions that never needed Phase I (full radiance
    # hit) — they paid zero probe samples, so the reuse fraction
    # counts them with the hits; with probe reuse ENABLED,
    # probes + skips == admissions holds as misses + hits + skips ==
    # admissions (every admission either probed [miss/refresh],
    # reused maps [hit], or skipped).  The ledger is the probe
    # caches' own: with reuse=None nothing is booked and the
    # fraction reads 0.0, not a fake 1.0 (full_radiance_hits still
    # counts engine-wide skips in that config).
    out["probe_skips"] = skips
    out["reused_probe_fraction"] = (
        (hits + skips) / max(hits + misses + skips, 1))
    out["probe_refreshes"] = sum(
        pc.refreshes for pc in probe_caches.values())
    r_hits = sum(rc.hits for rc in radiance_caches.values())
    r_miss = sum(rc.misses for rc in radiance_caches.values())
    out["radiance_hits"] = r_hits
    out["radiance_misses"] = r_miss
    out["reused_radiance_fraction"] = r_hits / max(r_hits + r_miss, 1)
    # scene-space block tier: hit rate over blocks that needed output
    # (delivered from the shared store vs actually marched; pad blocks
    # excluded from both sides)
    out["scene_block_hits"] = c.scene_blocks_hit
    out["scene_block_hit_rate"] = c.scene_blocks_hit / max(
        c.scene_blocks_hit + c.blocks_marched, 1)
    if scenecache is not None:
        out["scenecache"] = scenecache.stats()
    # weight-pack memoization ledger (kernels.ops.packed_weights): a
    # process-wide LRU shared by every engine — hits here are re-packed
    # weight chains AVOIDED on engine restarts / multi-scene hot-swap.
    # The ops module builds no kernel when imported, so it is imported
    # directly.
    pstats = kernel_ops.pack_cache_stats()
    out["pack_cache_hits"] = pstats["hits"]
    out["pack_cache_misses"] = pstats["misses"]
    out["pack_cache_size"] = pstats["size"]
    if registry is not None:
        for k, v in out.items():
            registry.set_value(k, v)
        return {k: registry.get(k).read() for k in out}
    return out
