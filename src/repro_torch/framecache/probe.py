"""Cross-frame Phase-I reuse: pose-keyed probe maps, warped by pose delta
(``repro.framecache.probe``).

The paper's §5.2.2 data reuse extended to the temporal axis: Phase-I
count/opacity/depth maps transfer between nearby camera poses, so most
frames of a smooth trajectory skip the probe entirely.

Two transfer modes, selected by ``ProbeReuseConfig.warp``:

  * warp=True (default) — the cached maps are reprojected to the
    requesting pose with the entry's own probe depth (warp.warp_count_map
    / warp.nearest_source).  Only disoccluded pixels fall back to the
    conservative fill (ns_full), plus a small fixed ``warp_margin``
    dilation for splat rounding — so the usable pose radius is bounded by
    the match thresholds, not by a global dilation cap.
  * warp=False — maps transfer untransformed and the WHOLE map is
    dilated by the worst-case pixel shift of the pose delta; a radius
    above ``dilate_cap`` is a miss (the conservative mode).

A pose delta whose worst-case pixel displacement rounds to zero skips the
warp entirely and returns the entry's maps untransformed — zero-distance
reuse is bit-exactly a re-probe.  The reference's ``probe_key`` is the
port's ``probe_jitter`` (uniform draws, as ``pipeline.probe_phase``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import adaptive, pipeline, scene
from ..core.fields import FieldFns
from ..core.pipeline import ASDRConfig
from ..obs import trace as trace_lib
from . import warp as warp_lib
from .base import PoseKeyedCache, mark_stream_use


@dataclasses.dataclass(frozen=True)
class ProbeReuseConfig:
    """When (and how) may a frame reuse another pose's Phase-I maps?

    A cached entry matches when BOTH the FULL relative-rotation angle
    (geodesic on SO(3) — an in-plane roll counts, since it permutes every
    pixel's ray) and the eye translation to the requesting pose are under
    the thresholds, and the image geometry (HxW, focal) is identical.
    ``refresh_every = k`` forces a fresh probe after an entry has been
    reused k times, bounding count-map staleness on long trajectories;
    0 disables refreshing.
    """
    max_angle_deg: float = 4.0
    max_translation: float = 0.08
    refresh_every: int = 8
    max_entries: int = 64
    # warp=True: reproject cached maps by the pose delta (depth-guided);
    # warp_margin is a FIXED post-warp max-dilation radius absorbing the
    # round-to-nearest splat error — NOT scaled with the pose delta.
    warp: bool = True
    warp_margin: int = 1
    # warp=False fallback: conservative whole-map dilation scaled to the
    # worst-case pixel shift (adaptive.reuse_dilation_radius); a pose delta
    # whose radius exceeds dilate_cap is a MISS (re-probe) — never a
    # smaller-than-safe dilation.
    dilate_margin: float = 1.5
    dilate_cap: int = 8


@dataclasses.dataclass
class ProbeMaps:
    """Phase-I products for one frame, all flat (H*W,) on device.

    cost is the probe's sample count — 0 when the maps were reused.
    depth is None on a dilation-mode (warp=False) reuse at nonzero pose
    delta: the entry's depth belongs to the CACHED pose's pixel grid and
    transferring it unwarped would misregister anything built on it.
    (The radiance store no longer consumes this map at all — finished
    frames are cached under the Phase-II march's own termination depth,
    which is pose-aligned by construction.)"""
    counts: torch.Tensor
    opacity: torch.Tensor
    depth: torch.Tensor | None
    cost: int


@dataclasses.dataclass
class _ProbeEntry:
    cam: "scene.Camera"
    acfg: ASDRConfig          # config the maps were probed under
    maps: ProbeMaps
    reuses_since_probe: int = 0
    last_used: int = 0
    seq: int = 0              # insertion order — eviction tie-break
    version: int = 0          # bumped on rebase — invalidates prepared plans


class ProbeCache(PoseKeyedCache):
    """Pose-keyed cache of Phase-I (counts, opacity, depth) maps.

    Matching/retention policy in base.PoseKeyedCache (shared with the
    radiance tier).  One cache per scene — poses from different fields
    must never share count maps.
    """

    def __init__(self, rcfg: ProbeReuseConfig | None = None):
        super().__init__(rcfg or ProbeReuseConfig())
        # admissions that consumed NO probe maps (full radiance hit
        # upstream): they are neither hits nor misses — the maps were
        # never needed — and MUST NOT age any entry (see note_skip)
        self.skips = 0

    def note_skip(self):
        """Record an admission that skipped Phase I entirely.

        A full radiance hit delivers the frame before the probe would
        run, so the admission consumes no count/opacity maps.  Counting
        it as a hit would age the matched entry (``reuses_since_probe``)
        and eventually force a refresh probe for maps nobody reads;
        counting it as a miss would run that probe immediately.  The skip
        is its own ledger line: the staleness bound stays "at most
        ``refresh_every`` CONSUMED reuses between probes", and
        ``hits + misses + skips`` equals admissions exactly.
        """
        with self.lock:
            self.skips += 1

    @property
    def no_probe_fraction(self) -> float:
        """Fraction of admissions that paid zero probe samples (hits via
        reuse plus full-radiance-hit skips) — the replay gate metric."""
        total = self.hits + self.misses + self.skips
        return (self.hits + self.skips) / total if total else 0.0

    def _entry_nbytes(self, entry) -> int:
        m = entry.maps
        return self._arrays_nbytes(m.counts, m.opacity, m.depth)

    def _store(self, cam, acfg, maps: ProbeMaps, replacing=None):
        clock = self._tick()
        if replacing is not None:
            replacing.cam = cam
            replacing.acfg = acfg
            replacing.maps = maps
            replacing.reuses_since_probe = 0
            replacing.last_used = clock
            replacing.version += 1
            return
        self._append_with_eviction(_ProbeEntry(cam, acfg, maps,
                                               last_used=clock))


def _fresh_probe(fns: FieldFns, acfg: ASDRConfig, cam, probe_jitter,
                 device) -> ProbeMaps:
    counts, cost, opacity, depth = pipeline.probe_phase(
        fns, acfg, cam, probe_jitter, return_opacity=True, return_depth=True,
        device=device)
    return ProbeMaps(counts, opacity, depth, cost)


def _warped_maps(src: ProbeMaps, src_cam, cam, acfg: ASDRConfig,
                 rcfg: ProbeReuseConfig) -> ProbeMaps:
    """A snapshot's maps reprojected to the requesting pose."""
    H, W = cam.height, cam.width
    tgt, ok, dist = warp_lib.forward_warp(src_cam, cam, src.depth)
    counts, _cvalid = warp_lib.warp_count_map(
        src.counts, src.depth, src_cam, cam, acfg.ns_full,
        margin=rcfg.warp_margin, projection=(tgt, ok, dist))
    sidx, valid = warp_lib.nearest_source(tgt, ok, dist, H * W)
    # disoccluded pixels: opacity 1.0 sorts them with the expensive rays
    # their ns_full count already makes them; depth parks at FAR so a
    # radiance frame built on these maps warps them as background.
    opacity = torch.where(valid, src.opacity[sidx], 1.0)
    depth = torch.where(valid, dist[sidx], scene.FAR)
    return ProbeMaps(counts, opacity, depth, 0)


# --------------------------------------------------------------- planning
#
# Phase I is split into three stages so the serving engine can speculate
# it ahead of need (double-buffered admission) without committing cache
# state it may have to revise:
#
#   plan_probe    — PURE decision against a snapshot of the cache;
#   execute_plan  — PURE device work (fresh probe / warp / dilate);
#   commit_plan   — the ONLY mutating stage (counters, stores, aging).
#
# A prepared (plan, maps) pair is valid for reuse iff the plan's
# ``basis`` — a fingerprint of every input the execution reads — still
# matches a freshly computed plan at commit time.  Fresh and refresh
# probes share the basis ``("probe",)``: both execute the same
# _fresh_probe(fns, acfg, cam, jitter), so speculated fresh maps survive a
# decision flip between them.  ``cached_probe_maps`` chains the three
# stages and is bit-identical to the pre-split single call.

@dataclasses.dataclass
class ProbePlan:
    """A pure Phase-I admission decision.

    kind: "fresh" (no usable entry), "reuse" (serve from ``entry`` in
    ``mode`` exact/warp/dilate), or "refresh" (entry matched but stale or
    past the dilation cap — probe now and rebase it).

    ``src_maps``/``src_cam`` are the entry state SNAPSHOT execution reads,
    captured atomically under the cache lock at plan time: the live entry
    may be rebased (fields reassigned, version bumped) by a commit on the
    engine thread while a worker executes this plan, but the snapshot
    stays internally consistent and the ``basis`` version stamp flags the
    result stale at commit.
    """
    kind: str
    entry: object | None = None
    mode: str = "probe"        # reuse flavor: "exact" | "warp" | "dilate"
    radius: int = 0            # dilate-mode dilation radius
    basis: tuple = ("probe",)  # fingerprint of the inputs execution reads
    src_maps: ProbeMaps | None = None
    src_cam: object | None = None


def plan_probe(cache: ProbeCache | None, cam, acfg: ASDRConfig) -> ProbePlan:
    """Decide how this admission gets its Phase-I maps.  Pure: reads the
    cache, mutates nothing — safe to run speculatively (from any thread)
    and re-run at commit time to revalidate a prepared plan.  The entry
    read is a consistent snapshot taken under the cache lock."""
    with trace_lib.span("probe.plan") as sp:
        plan = _plan_probe(cache, cam, acfg)
        if sp is not trace_lib.NULL_SPAN:
            # the decision is the payload — stamped after it's made
            sp.attrs["kind"] = plan.kind
            sp.attrs["mode"] = plan.mode
        return plan


def _plan_probe(cache, cam, acfg: ASDRConfig) -> ProbePlan:
    if cache is None:
        return ProbePlan("fresh")
    with cache.lock:
        match = cache._match(cam, acfg)
        if match is None:
            return ProbePlan("fresh")
        entry, ang, tr = match
        rcfg = cache.rcfg
        k = rcfg.refresh_every
        stale = k > 0 and entry.reuses_since_probe >= k
        # worst-case pixel displacement of the delta (margin 1.0 = the
        # true bound): 0 means no content crossed a pixel boundary and
        # the maps transfer bit-exactly, warp or no warp
        shift = adaptive.reuse_dilation_radius(cam, ang, tr, scene.NEAR,
                                               margin=1.0)
        if rcfg.warp:
            usable, radius = not stale, 0
        else:
            radius = adaptive.reuse_dilation_radius(
                cam, ang, tr, scene.NEAR, margin=rcfg.dilate_margin,
            ) if rcfg.dilate_margin > 0 else 0
            usable = radius <= rcfg.dilate_cap and not stale
        if not usable:
            # re-probe at the CURRENT pose and rebase the entry: either a
            # scheduled refresh (k-th consumed reuse) or — in dilation
            # mode — a pose delta whose radius overflows dilate_cap
            return ProbePlan("refresh", entry)
        mode = "exact" if shift == 0 else ("warp" if rcfg.warp else "dilate")
        mark_stream_use(entry.maps.counts, entry.maps.opacity,
                        entry.maps.depth)
        return ProbePlan("reuse", entry, mode, radius,
                         basis=(mode, id(entry), entry.version, radius),
                         src_maps=entry.maps, src_cam=entry.cam)


def execute_probe_plan(fns: FieldFns, acfg: ASDRConfig, cam,
                       plan: ProbePlan, probe_jitter=None,
                       rcfg: ProbeReuseConfig | None = None,
                       device=None) -> ProbeMaps:
    """Run the device work the plan calls for.  Pure, and touches only
    the plan's snapshot (never the live entry) — dispatchable on a worker
    thread while an earlier march is still in flight."""
    with trace_lib.span("probe.execute", kind=plan.kind, mode=plan.mode):
        if plan.kind in ("fresh", "refresh"):
            return _fresh_probe(fns, acfg, cam, probe_jitter, device)
        if plan.mode == "exact":
            return dataclasses.replace(plan.src_maps, cost=0)
        if plan.mode == "warp":
            return _warped_maps(plan.src_maps, plan.src_cam, cam, acfg,
                                rcfg)
        counts = adaptive.dilate_count_map(
            plan.src_maps.counts, (cam.height, cam.width), plan.radius,
            border_fill=acfg.ns_full)
        # depth=None: the entry's depth is in the CACHED pose's pixel
        # grid and this mode (by definition) does not warp — see
        # ProbeMaps docstring
        return ProbeMaps(counts, plan.src_maps.opacity, None, 0)


def commit_probe_plan(cache: ProbeCache | None, cam, acfg: ASDRConfig,
                      plan: ProbePlan, maps: ProbeMaps) -> bool:
    """Apply the plan's bookkeeping; returns reused.  The only stage that
    mutates the cache, so all aging/stores happen at one deterministic
    point (admission, engine thread) regardless of how early — or on
    which thread — the maps were computed."""
    if cache is None:
        return False
    with trace_lib.span("probe.commit", kind=plan.kind), cache.lock:
        if plan.kind == "reuse":
            cache.hits += 1
            plan.entry.reuses_since_probe += 1
            plan.entry.last_used = cache._tick()
            return True
        if plan.kind == "refresh":
            cache.refreshes += 1
            cache.misses += 1
            cache._store(cam, acfg, maps, replacing=plan.entry)
            return False
        cache.misses += 1
        cache._store(cam, acfg, maps)
        return False


def cached_probe_maps(fns: FieldFns, acfg: ASDRConfig, cam,
                      cache: ProbeCache | None, probe_jitter=None,
                      device=None):
    """Phase I with cross-frame reuse: returns (ProbeMaps, reused: bool).

    maps.cost is 0 on a cache hit — the whole point: a reused frame pays
    only Phase II.  Opacity/depth are always produced so the serving
    engine can sort pooled blocks and feed the radiance cache.
    Plan + execute + commit in one synchronous step — the sequential
    path; the serving engine drives the stages separately to overlap
    execution with the pooled march.
    """
    plan = plan_probe(cache, cam, acfg)
    maps = execute_probe_plan(fns, acfg, cam, plan, probe_jitter,
                              rcfg=cache.rcfg if cache is not None else None,
                              device=device)
    reused = commit_probe_plan(cache, cam, acfg, plan, maps)
    return maps, reused


def probe_phase_cached(fns: FieldFns, acfg: ASDRConfig, cam,
                       cache: ProbeCache | None, probe_jitter=None,
                       device=None):
    """Compat wrapper with the pre-framecache contract.

    Returns (counts (H*W,), probe_cost, opacity (H*W,), reused: bool) —
    exactly what core.pipeline.probe_phase_cached returned before the
    subsystem moved here.  New code should use ``cached_probe_maps``.
    """
    maps, reused = cached_probe_maps(fns, acfg, cam, cache, probe_jitter,
                                     device)
    return maps.counts, maps.cost, maps.opacity, reused
