"""Admission layer: Stage-A speculation and the Stage-B commit
(``repro.serve.admission``).

Admission is a two-stage, radiance-first pipeline:

  Stage A (``prepare``) — PURE speculation, runnable ahead of need on
    ANY thread (see executor.py) while the dispatched march is in
    flight: radiance plan first (warp included), probe plan + its device
    execution only on a non-full hit, and the slot's padded/budget-sorted
    block layout (``pool.build_layout``) — the pad/sort that used to run
    inside the commit.  No cache mutates.
  Stage B (``admit``) — the scheduling round consumes a slot, engine
    thread only: every plan is revalidated against the CURRENT cache
    state, stale speculation is re-executed (counted in ``misprepares``,
    still pre-commit), and then the commit section applies ALL cache
    bookkeeping — so admission decisions, rendered frames, and the
    deterministic counters are bit-identical at every prefetch depth and
    worker count.

The commit section performs NO device-shape work (no pad/sort, no warp,
no probe): everything it consumes was produced by Stage-A code paths.
Stage A runs on the card a ``DeviceExecutor`` placed it on
(``executor.placement()``), with the fields' replica for that card and
copies of what it reads from the engine's caches, else on the engine's
card (``engine.device``); ``take`` hands a placed result to the engine's
card (``Prepared.to_device``), so Stage B and the march see only tensors
there.  A slot's result buffers and the finished frame are host numpy,
filled by one copy of each collected batch's outputs.
``commit_active()`` exposes that window for test instrumentation.

Ordering is radiance-FIRST: the radiance lookup runs before Phase I, so
a full warp hit (zero disoccluded rays) never pays the probe it would
immediately discard — the skip is booked explicitly via
``ProbeCache.note_skip`` so reuse fractions and staleness bounds stay
coherent.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import prng
from ..core import scene
from ..core.pipeline import ASDRConfig
from ..framecache import probe as fc_probe
from ..framecache import radiance as fc_radiance
from ..framecache.probe import ProbeMaps, ProbeReuseConfig
from ..framecache.radiance import RadianceReuseConfig
from ..obs import trace as trace_lib
from ..obs.trace import TraceConfig
from ..scenecache import SceneCacheConfig
from . import executor as executor_lib
from . import pool as pool_lib
from . import scheduler as scheduler_lib
from .scheduler import DEFAULT_CLASS, RequestClass  # noqa: F401 (surface)


@dataclasses.dataclass(frozen=True)
class RenderServeConfig:
    slots: int = 4
    blocks_per_batch: int = 16
    reuse: Optional[ProbeReuseConfig] = ProbeReuseConfig()
    # warped-radiance reuse is opt-in: None keeps the engine bit-identical
    # to the single-image pipeline (the identity tests rely on this)
    radiance: Optional[RadianceReuseConfig] = None
    # scene-space block reuse (repro.scenecache) is likewise opt-in: None
    # leaves the pooled-march path untouched.  An explicit SceneBlockCache
    # instance passed to the engine constructor overrides this config —
    # that is how several engines over one scene share a single store.
    scenecache: Optional[SceneCacheConfig] = None
    probe_seed: Optional[int] = None   # None = deterministic midpoint probe
    # Stage-A lookahead: up to this many QUEUED requests have their
    # radiance lookup + probe + layout speculated each round while the
    # dispatched march is still in flight (0 = fully synchronous
    # admission).  All cache bookkeeping commits at admission regardless,
    # so rendered frames and counters are bit-identical at every prefetch
    # depth — speculation only moves the device work earlier.
    prefetch: int = 2
    # Stage-A executor worker threads: 0 = synchronous executor (inline
    # speculation on the engine thread, the bit-identical default); n > 0
    # runs prepare() on n worker threads, each on a CUDA stream of its
    # own, so probe/warp DEVICE time overlaps march device time.  Commits
    # stay on the engine thread in admission order at any worker count.
    workers: int = 0
    # Multi-device Stage-A placement (the fleet tier): n > 0 places
    # speculation on up to n SECONDARY cards (cuda:1 .., round-robin per
    # slot), each with a replica of the fields, while the pooled march
    # owns the engine's card.  Takes precedence over ``workers``; gives
    # the synchronous executor on a one-card host (executor.make_executor),
    # still on the card.
    devices: int = 0
    # Streaming dispatch: up to this many batches launched per scheduling
    # round (pool.dispatch_round) — when the largest-budget scene group
    # runs dry, the next group's blocks fill the remaining launches, and
    # all launches are in flight before any is collected (the double
    # buffer).  1 = the classic one-batch round, bit-identical to every
    # prior config.
    inflight_batches: int = 1
    # Opt-in density-only refresh marches: a PARTIAL radiance hit also
    # marches its warp-valid rays through the color-free march (the
    # fused kernel skips the color chain), recovering exact acc/depth so
    # the warped frame re-enters the radiance cache instead of being
    # a reuse dead-end.  Off by default: refreshed frames keep their
    # warped rgb, so enabling this trades a bounded quality drift
    # (min_valid_fraction / refresh_every still apply) for reuse reach.
    density_refresh: bool = False
    # Request-lifecycle scheduling policy (serve/scheduler.py): None or
    # "fifo" = arrived requests in queue order, bit-identical to the
    # pre-scheduler engine; "edf" drains slots earliest-deadline-first;
    # "shed" additionally degrades a request's sample-budget tier
    # (never below its class's shed floor) when the admission stall it
    # absorbed ate its deadline slack.  Also accepts a policy instance.
    policy: Optional[object] = None
    # Observability (repro.obs): None = tracing fully off — every
    # instrumented call site takes the null-span fast path, and frames +
    # deterministic counters are bit-identical either way (spans only
    # read ids/clocks, never steer scheduling; tests/test_obs.py gates
    # this across executors x prefetch depths).  A TraceConfig names the
    # export paths, flight-recorder mode, and metrics snapshot cadence.
    trace: Optional[TraceConfig] = None


@dataclasses.dataclass
class RenderRequest:
    """A frame request; ``image`` is the finished (H, W, 3) float32 frame
    on the host."""
    rid: int
    scene: str                         # key into the engine's field table
    cam: scene.Camera
    image: Optional[np.ndarray] = None   # (H, W, 3) on completion
    stats: Dict = dataclasses.field(default_factory=dict)
    latency_s: float = 0.0
    # request-lifecycle contract (serve/scheduler.py): the SLO class,
    # the open-loop arrival offset (seconds after render() entry; 0 =
    # closed loop, already arrived — the latency clock starts at
    # arrival, so queue wait is measured from when the client showed
    # up, not from batch submission), and the MUTABLE budget tier the
    # scheduler may degrade (``degrades`` counts the steps taken).
    cls: RequestClass = DEFAULT_CLASS
    arrival_s: float = 0.0
    tier: int = -1                     # -1: start at cls.tier
    degrades: int = 0

    def __post_init__(self):
        if self.tier < 0:
            self.tier = self.cls.tier


def _radiance_token(rplan) -> tuple:
    """The radiance-side fingerprint a speculated layout depends on: a
    hit's basis pins the exact warped arrays (march_idx/base_rgb), any
    miss marches every ray regardless of reason."""
    if rplan is None:
        return ("none",)
    return ("hit", rplan.basis) if rplan.kind == "hit" else ("miss",)


@dataclasses.dataclass
class Prepared:
    """Stage-A speculation for one queued request: pure plans plus their
    executed device work and block layout, awaiting admission commit."""
    req: RenderRequest
    rplan: Optional["fc_radiance.RadiancePlan"]
    pplan: Optional["fc_probe.ProbePlan"]
    maps: Optional[ProbeMaps]
    layout: pool_lib.BlockLayout
    r_token: tuple
    prep_s: float
    dens_layout: Optional[pool_lib.BlockLayout] = None
    # budget tier the layout was built at: admission re-prepares when
    # the scheduler degraded the request after this speculation ran
    tier: int = 0

    def tensors(self):
        """The device tensors this speculation produced: what a threaded
        executor hands over to the engine's stream at ``take``."""
        m, rays = self.maps, self.layout.rays
        out = [rays[0], rays[1]]
        if m is not None:
            out += [m.counts, m.opacity, m.depth]
        if self.dens_layout is not None:
            out += list(self.dens_layout.rays)
        w = self.rplan.warped if self.rplan is not None else None
        if w is not None:
            out += [w.rgb, w.valid]
        return out

    def to_device(self, device) -> "Prepared":
        """This speculation with every tensor Stage B and the pool read
        (the rays of both layouts, the probe maps, the radiance plan's
        warp) on ``device``; itself when they all lie there."""
        device = executor_lib.indexed(device)
        if all(t is None or t.device == device for t in self.tensors()):
            return self

        def to(t):
            return None if t is None else t.to(device)

        def lay(layout):
            return None if layout is None else dataclasses.replace(
                layout, rays=tuple(to(t) for t in layout.rays))

        rplan, m = self.rplan, self.maps
        if rplan is not None and rplan.warped is not None:
            w = rplan.warped
            rplan = dataclasses.replace(rplan, warped=dataclasses.replace(
                w, rgb=to(w.rgb), valid=to(w.valid)))
        if m is not None:
            m = ProbeMaps(to(m.counts), to(m.opacity), to(m.depth), m.cost)
        return dataclasses.replace(self, rplan=rplan, maps=m,
                                   layout=lay(self.layout),
                                   dens_layout=lay(self.dens_layout))

    def block_until_ready(self):
        """Wait for the speculated device buffers: the executor's wait, a
        synchronize of the current stream of each card they lie on (on a
        worker, the worker's own stream)."""
        executor_lib.block_until_ready(*self.tensors())


# Engine-thread-only depth counter marking the Stage-B commit section —
# pool.build_layout and the framecache execute stages must never run
# inside it (tests/test_executor.py instruments this).
_commit_depth = 0


def commit_active() -> bool:
    return _commit_depth > 0


def prepare(engine, req: RenderRequest) -> Prepared:
    """Stage A: speculate the admission's device work — radiance warp,
    probe/warp maps, and the padded/sorted block layout — without
    touching any cache.  Pure, thread-safe (plans snapshot entry state
    under the cache locks), dispatchable while live requests march."""
    t0 = time.time()
    acfg: ASDRConfig = engine.acfg
    # the placement card, else the engine's: the fields' replica there,
    # the cached maps and frames this reads copied there
    dev = executor_lib.placement() or engine.device
    with trace_lib.span("stage_a.prepare", req=req.rid, scene=req.scene):
        rad = engine.radiance_caches.get(req.scene)
        rplan = (fc_radiance.plan_lookup(rad, req.cam, acfg, device=dev)
                 if rad is not None else None)
        pplan = maps = None
        if rplan is None or not rplan.full_hit:
            cache = engine.probe_caches.get(req.scene)
            pplan = fc_probe.plan_probe(cache, req.cam, acfg)
            maps = fc_probe.execute_probe_plan(
                engine.replicas.on(req.scene, dev), acfg, req.cam, pplan,
                engine._probe_key(req, dev),
                rcfg=cache.rcfg if cache is not None else None,
                device=dev)
        warped = rplan.warped if (rplan is not None
                                  and rplan.kind == "hit") else None
        tier = req.tier
        scale = scheduler_lib.budget_scale_for(req)
        with trace_lib.span("stage_a.layout", req=req.rid, tier=tier):
            layout = pool_lib.build_layout(acfg, req.cam, maps, warped,
                                           budget_scale=scale, device=dev)
            dens_layout = None
            if (engine.rcfg.density_refresh and warped is not None
                    and maps is not None):
                dens_layout = pool_lib.build_density_layout(
                    acfg, req.cam, maps, warped, budget_scale=scale,
                    device=dev)
    return Prepared(req, rplan, pplan, maps, layout,
                    _radiance_token(rplan), time.time() - t0, dens_layout,
                    tier=tier)


def admit(engine, req: RenderRequest, prepared: Prepared,
          t_enqueue: Optional[float] = None) -> "Slot":
    """Stage B: revalidate the speculation against current cache state,
    re-executing stale pieces, then commit.  Engine thread only."""
    with trace_lib.span("stage_b.admit", req=req.rid, scene=req.scene):
        return _admit(engine, req, prepared, t_enqueue)


def _admit(engine, req: RenderRequest, prepared: Prepared,
           t_enqueue: Optional[float]) -> "Slot":
    global _commit_depth
    acfg: ASDRConfig = engine.acfg
    counters = engine.counters

    # ---- tier revalidation: the scheduler degraded this request AFTER
    # its speculation ran.  Probe maps and radiance plans are
    # tier-INDEPENDENT (the tier only scales the layout's budgets), so
    # the plans below revalidate normally and only the layout is
    # rebuilt — at the current tier, via the Stage-A code path, still
    # pre-commit.  ``shed_reprepares`` counts the discarded layouts.
    tier_stale = prepared.tier != req.tier
    if tier_stale:
        counters.shed_reprepares += 1

    # ---- revalidation: pure re-plans; stale speculation re-executes
    # here via Stage-A code paths, BEFORE the commit section
    rad = engine.radiance_caches.get(req.scene)
    rplan = None
    if rad is not None:
        sp = prepared.rplan
        rplan = fc_radiance.plan_lookup(rad, req.cam, acfg, prepared=sp)
        if (sp is not None and sp.warped is not None
                and sp.basis != rplan.basis):
            # the speculated warp's source entry changed (rebase /
            # eviction) between Stage A and admission — re-warped
            counters.misprepares += 1
    # what commit_lookup will return: the plan's warp on a hit, None on
    # any miss — needed pre-commit for the layout decision
    warped = rplan.warped if (rplan is not None
                              and rplan.kind == "hit") else None
    probe_skipped = warped is not None and warped.full_hit
    cache = engine.probe_caches.get(req.scene)
    if probe_skipped:
        if prepared.maps is not None:
            # speculated a probe for a frame that turned out fully
            # warp-served (its source finished after Stage A ran)
            counters.misprepares += 1
        pplan = maps = None
    else:
        pplan = fc_probe.plan_probe(cache, req.cam, acfg)
        if (prepared.pplan is not None
                and prepared.pplan.basis == pplan.basis):
            maps = prepared.maps
        else:
            counters.misprepares += 1
            maps = fc_probe.execute_probe_plan(
                engine.fields[req.scene], acfg, req.cam, pplan,
                engine._probe_key(req),
                rcfg=cache.rcfg if cache is not None else None,
                device=engine.device)
    # layout revalidation: reusable iff the maps are the speculated ones
    # AND the radiance side resolved to the same warp (same march_idx)
    # AND the budget tier didn't degrade since the layout was built
    if (maps is prepared.maps and not tier_stale
            and _radiance_token(rplan) == prepared.r_token):
        layout = prepared.layout
        dens_layout = prepared.dens_layout
    else:
        layout = pool_lib.build_layout(
            acfg, req.cam, maps, warped,
            budget_scale=scheduler_lib.budget_scale_for(req),
            device=engine.device)
        dens_layout = None
    if (engine.rcfg.density_refresh and dens_layout is None
            and warped is not None and maps is not None):
        dens_layout = pool_lib.build_density_layout(
            acfg, req.cam, maps, warped,
            budget_scale=scheduler_lib.budget_scale_for(req),
            device=engine.device)

    # ---- commit section: cache bookkeeping ONLY — no device-shape work
    _commit_depth += 1
    try:
        with trace_lib.span("commit", req=req.rid, scene=req.scene):
            counters.admissions += 1
            if rad is not None:
                fc_radiance.commit_lookup(rad, rplan)
            reused = False
            if probe_skipped:
                if cache is not None:
                    cache.note_skip()
                counters.full_radiance_hits += 1
            else:
                reused = fc_probe.commit_probe_plan(cache, req.cam, acfg,
                                                    pplan, maps)
            slot = Slot(req, layout, maps, reused, acfg.block_size,
                        probe_skipped=probe_skipped, t_enqueue=t_enqueue,
                        dens_layout=dens_layout)
    finally:
        _commit_depth -= 1
    return slot


class Slot:
    """A live request: its block layout and result buffers.

    With radiance reuse, ``layout.march_idx`` selects the disoccluded
    rays the slot actually marches (None = all rays) and
    ``layout.base_rgb`` holds the warped cached frame the marched rays
    composite over.
    """

    def __init__(self, req: RenderRequest, layout: pool_lib.BlockLayout,
                 maps: Optional[ProbeMaps], reused: bool, block_size: int,
                 probe_skipped: bool = False,
                 t_enqueue: Optional[float] = None,
                 dens_layout: Optional[pool_lib.BlockLayout] = None):
        self.req = req
        self.layout = layout
        self.rays = layout.rays          # padded (origins, dirs)
        self.order = layout.order
        self.budgets = layout.budgets
        self.pad = layout.pad
        self.maps = maps                 # None on a full radiance hit
        self.reused = reused
        self.probe_skipped = probe_skipped
        self.block_size = block_size
        self.march_idx = layout.march_idx
        self.base_rgb = layout.base_rgb
        self.warp_valid_fraction = layout.valid_fraction
        n_blocks = layout.budgets.shape[0]
        self.rgb = np.zeros((n_blocks, block_size, 3), np.float32)
        self.acc = np.zeros((n_blocks, block_size), np.float32)
        self.depth = np.zeros((n_blocks, block_size), np.float32)
        self.chunks = np.zeros((n_blocks,), np.int64)
        self.cached_blocks = 0        # delivered from the scene store
        self.cached_chunks = 0
        # density-only refresh (opt-in): a second block layout over the
        # warp-VALID rays whose acc/depth a color-free march recovers
        self.dens_layout = dens_layout
        n_dens = 0
        if dens_layout is not None:
            n_dens = dens_layout.budgets.shape[0]
            self.dens_acc = np.zeros((n_dens, block_size), np.float32)
            self.dens_depth = np.zeros((n_dens, block_size), np.float32)
            self.dens_chunks = np.zeros((n_dens,), np.int64)
        self.pending = n_blocks + n_dens
        # latency clock starts at ENQUEUE (render() entry), not slot
        # construction — latency_s must cover queue wait + admission
        # (probe/warp) + march end-to-end under the double-buffered path
        self.t0 = time.time() if t_enqueue is None else t_enqueue
        self.admission_s = 0.0        # total Stage-A + Stage-B work time
        self.admit_stall_s = 0.0      # blocking admission time (Stage B
        #                               + any inline/awaited Stage A)

    def sorted_rays(self, origins, dirs, order=None):
        """(o, d) gathered into block order, (n_blocks, B, 3) each."""
        order = self.order if order is None else order
        idx = torch.from_numpy(np.asarray(order, np.int64)).to(
            origins.device)
        B = self.block_size
        return (origins[idx].reshape(-1, B, 3),
                dirs[idx].reshape(-1, B, 3))

    def emit_blocks(self, o_s, d_s):
        """(slot, block_index, o (B,3), d (B,3), budget) work items of the
        rays in block order (``sorted_rays``)."""
        for bi in range(self.budgets.shape[0]):
            yield (self, bi, o_s[bi], d_s[bi], int(self.budgets[bi]))

    def emit_density_blocks(self):
        """Density-refresh work items, same shape as ``emit_blocks`` —
        the pool tags them so ``collect`` routes to deliver_density."""
        if self.dens_layout is None:
            return
        lay = self.dens_layout
        o_s, d_s = self.sorted_rays(*lay.rays, order=lay.order)
        for bi in range(lay.budgets.shape[0]):
            yield (self, bi, o_s[bi], d_s[bi], int(lay.budgets[bi]))

    def deliver(self, bi: int, rgb, acc, depth, chunks, cached: bool = False):
        self.rgb[bi] = rgb
        self.acc[bi] = acc
        self.depth[bi] = depth
        self.chunks[bi] = chunks
        if cached:
            self.cached_blocks += 1
            self.cached_chunks += int(chunks)
        self.pending -= 1

    def deliver_density(self, bi: int, acc, depth, chunks):
        self.dens_acc[bi] = acc
        self.dens_depth[bi] = depth
        self.dens_chunks[bi] = chunks
        self.pending -= 1

    def finalize(self, acfg: ASDRConfig) -> RenderRequest:
        req = self.req
        H, W = req.cam.height, req.cam.width
        R = H * W
        Rp = self.order.shape[0]
        if Rp:
            inv = np.zeros((Rp,), np.int64)
            inv[np.asarray(self.order)] = np.arange(Rp)
            flat = self.rgb.reshape(Rp, 3)[inv]
            acc_flat = self.acc.reshape(Rp)[inv]
            depth_flat = self.depth.reshape(Rp)[inv]
        else:
            flat = np.zeros((0, 3), np.float32)
            acc_flat = np.zeros((0,), np.float32)
            depth_flat = np.zeros((0,), np.float32)
        if self.march_idx is None:
            img_flat = flat[:R]
            self.acc_full = acc_flat[:R]
            # the march's per-ray termination depth: what the radiance
            # cache warps this frame with (sharper than the probe's
            # stride-d proxy at depth edges)
            self.depth_full = depth_flat[:R]
            rays_marched = R
        else:
            img_flat = self.base_rgb.copy()
            img_flat[self.march_idx] = flat[: self.march_idx.size]
            if self.dens_layout is not None:
                # density refresh: every image ray now has an exact
                # marched acc/depth — disoccluded rays from the color
                # march, warp-valid rays from the density-only march —
                # so this warped frame IS radiance-cacheable
                lay = self.dens_layout
                dRp = lay.order.shape[0]
                dinv = np.zeros((dRp,), np.int64)
                dinv[np.asarray(lay.order)] = np.arange(dRp)
                dacc = self.dens_acc.reshape(dRp)[dinv]
                ddep = self.dens_depth.reshape(dRp)[dinv]
                acc_full = np.zeros((R,), np.float32)
                depth_full = np.zeros((R,), np.float32)
                acc_full[self.march_idx] = acc_flat[: self.march_idx.size]
                depth_full[self.march_idx] = depth_flat[: self.march_idx.size]
                acc_full[lay.march_idx] = dacc[: lay.march_idx.size]
                depth_full[lay.march_idx] = ddep[: lay.march_idx.size]
                self.acc_full, self.depth_full = acc_full, depth_full
            else:
                self.acc_full = None   # warped frames are never re-cached
                self.depth_full = None
            rays_marched = int(self.march_idx.size)
        req.image = img_flat.reshape(H, W, 3)
        req.latency_s = time.time() - self.t0
        # rays delivered straight from the warp: had they marched, the
        # fixed-budget baseline would have spent ns_full samples each —
        # the same convention baseline_samples uses — so zero-march
        # frames report reused compute instead of silently vanishing
        # from the samples split
        warp_rays = 0 if self.march_idx is None else R - rays_marched
        req.stats = {
            "probe_samples": 0 if self.maps is None else self.maps.cost,
            "probe_reused": self.reused,
            "probe_skipped": self.probe_skipped,
            "radiance_reused": self.march_idx is not None,
            "rays_marched": rays_marched,
            "rays_total": R,
            "warp_valid_fraction": self.warp_valid_fraction,
            # compute actually spent: scene-store hits replay stored
            # outputs without marching, so their chunks count as REUSED
            # samples, not processed ones — the compute-fraction metrics
            # must show the scene tier's savings.  Density-refresh chunks
            # are real (color-free) march compute and count as processed.
            "samples_processed":
                (int(self.chunks.sum()) - self.cached_chunks
                 + (int(self.dens_chunks.sum())
                    if self.dens_layout is not None else 0))
                * self.block_size * acfg.chunk,
            "density_rays": (0 if self.dens_layout is None
                             else int(self.dens_layout.march_idx.size)),
            "samples_reused": self.cached_chunks
            * self.block_size * acfg.chunk + warp_rays * acfg.ns_full,
            "scene_block_hits": self.cached_blocks,
            # padded ray count, matching render_adaptive's stats — the
            # numerator includes the pad rays' chunks, so the denominator
            # must too or the fraction inflates (and can exceed 1.0)
            "baseline_samples": Rp * acfg.ns_full,
            "admission_s": self.admission_s,
            "admit_stall_s": self.admit_stall_s,
            # request-lifecycle accounting (serve/scheduler.py): the SLO
            # class this frame was served under, the tier it ENDED at,
            # how many degrade steps the scheduler applied, and whether
            # the end-to-end latency met the class deadline (inf-deadline
            # classes always do)
            "class": req.cls.name,
            "tier": req.tier,
            "degrades": req.degrades,
            "deadline_met": req.latency_s * 1e3 <= req.cls.deadline_ms,
        }
        return req


def probe_jitter_for(rcfg: RenderServeConfig, req: RenderRequest,
                     acfg: ASDRConfig, device):
    """The probe's stratified-sampling draws for a seeded request: (probe
    rays, ``ns_full``) uniforms of ``PRNGKey(probe_seed + rid)`` made on
    ``device``, the draws of the reference's ``probe_key_for``.  None with
    ``probe_seed`` None, the midpoint probe."""
    if rcfg.probe_seed is None:
        return None
    st = acfg.probe_stride
    n = (-(-req.cam.height // st)) * (-(-req.cam.width // st))
    return prng.uniform(prng.PRNGKey(rcfg.probe_seed + req.rid),
                        (n, acfg.ns_full), device=device)
