"""Cross-frame reuse of finished Phase-II radiance — the big frame lever
(``repro.framecache.radiance``).

A completed frame (rgb, acc) plus its per-ray march termination depth
(full resolution, from the Phase-II march — sharper at depth edges
than the probe's stride-d proxy it replaced) is cached keyed by
(scene, pose, acfg).  A later request within the radiance-reuse
radius warps the cached frame to its own pose (warp.warp_image, z-buffered
nearest-surface) and receives a per-pixel validity mask: VALID pixels take
the warped radiance directly and skip Phase II entirely; only the INVALID
(disoccluded) rays are marched through the block pipeline and composited
over the warp.  On a smooth trajectory most rays of most frames never
touch the field network.

Safety invariants:

  * only FULLY-rendered frames are stored — a frame assembled from a warp
    is never re-cached, so warps never chain and drift is bounded by one
    reprojection from an honestly rendered frame;
  * ``refresh_every`` forces a full render after an entry has been reused
    k times, bounding staleness on long dwells;
  * a warp whose valid fraction drops below ``min_valid_fraction`` is a
    MISS (full render), so a degenerate warp can never dominate a frame;
  * zero pixel displacement skips the warp — replaying a pose returns the
    cached frame bit-exactly.

Host-side bookkeeping mirrors probe.ProbeCache; the frames and the
validity mask stay on the device.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import adaptive, scene
from ..core.pipeline import ASDRConfig
from ..obs import trace as trace_lib
from . import warp as warp_lib
from .base import PoseKeyedCache, mark_stream_use


@dataclasses.dataclass(frozen=True)
class RadianceReuseConfig:
    """When may a frame reuse another pose's finished radiance?

    Deliberately tighter defaults than ProbeReuseConfig: warped radiance
    is the final image (errors are visible), while warped counts only
    steer sampling (errors cost samples, not quality).
    """
    max_angle_deg: float = 2.0
    max_translation: float = 0.04
    refresh_every: int = 4
    max_entries: int = 32
    min_valid_fraction: float = 0.6


@dataclasses.dataclass
class WarpedRadiance:
    """A cached frame reprojected to the requesting pose.

    Deliberately rgb + validity only: warped frames are never re-cached
    (invariant above), so consumers have no use for warped acc/depth —
    they composite marched rays over ``rgb`` where ``valid`` is False.
    """
    rgb: torch.Tensor      # (H*W, 3)
    valid: torch.Tensor    # (H*W,) bool on rgb's device: drives ray selection
    valid_fraction: float

    @property
    def full_hit(self) -> bool:
        """Every pixel valid: the frame is delivered entirely from the
        warp — zero rays march, and Phase I can be skipped outright."""
        return self.valid_fraction == 1.0


@dataclasses.dataclass
class _RadianceEntry:
    cam: "scene.Camera"
    acfg: ASDRConfig
    rgb: torch.Tensor
    acc: torch.Tensor
    depth: torch.Tensor
    reuses_since_render: int = 0
    last_used: int = 0
    seq: int = 0              # insertion order — eviction tie-break
    version: int = 0          # bumped on rebase — invalidates prepared plans


class RadianceCache(PoseKeyedCache):
    """Pose-keyed cache of finished Phase-II frames, one per scene.

    Matching/retention policy in base.PoseKeyedCache (shared with the
    probe tier)."""

    def __init__(self, rcfg: RadianceReuseConfig | None = None):
        super().__init__(rcfg or RadianceReuseConfig())
        self.low_valid_misses = 0

    def _entry_nbytes(self, entry) -> int:
        return self._arrays_nbytes(entry.rgb, entry.acc, entry.depth)

    # ------------------------------------------------------------- lookup
    def lookup(self, cam, acfg: ASDRConfig) -> WarpedRadiance | None:
        """Warped cached frame for this pose, or None (= render fully).

        A None return already counted as a miss; the caller should render
        the frame normally and hand it back via ``store``.  Plan + commit
        in one synchronous step — the sequential path; the serving engine
        drives the stages separately (plan_lookup speculatively ahead of
        need, commit_lookup at admission).
        """
        return commit_lookup(self, plan_lookup(self, cam, acfg))

    # -------------------------------------------------------------- store
    def store(self, cam, acfg: ASDRConfig, rgb, acc, depth):
        """Cache a FULLY-rendered frame (never a warped composite).

        A rebase reassigns the entry's array fields and bumps its version
        in one critical section — concurrent plan snapshots (taken under
        the same lock) therefore always see arrays and version of ONE
        generation (never a torn entry)."""
        with self.lock:
            clock = self._tick()
            match = self._match(cam, acfg)
            if match is not None:    # rebase the nearby entry (refresh)
                entry, _, _ = match
                entry.cam = cam
                entry.acfg = acfg
                entry.rgb, entry.acc, entry.depth = rgb, acc, depth
                entry.reuses_since_render = 0
                entry.last_used = clock
                entry.version += 1
                return
            self._append_with_eviction(
                _RadianceEntry(cam, acfg, rgb, acc, depth, last_used=clock))


# --------------------------------------------------------------- planning
#
# The radiance lookup split the same way as framecache.probe: a PURE plan
# stage the serving engine may run speculatively (double-buffered
# admission), and a commit stage — the only mutating one — applied at the
# deterministic admission point.  Unlike the probe, the warp itself is
# part of the DECISION (the low-valid-fraction miss needs the warped
# validity mask), so plan_lookup computes it; a prepared plan whose
# ``basis`` still matches hands its arrays over without re-warping.

@dataclasses.dataclass
class RadiancePlan:
    """A pure Phase-II-reuse decision.

    kind "hit" carries the warped frame; kind "miss" carries the reason
    ("no_match" | "refresh" | "low_valid") so commit books the right
    counter.
    """
    kind: str
    reason: str | None = None
    entry: object | None = None
    warped: WarpedRadiance | None = None
    basis: tuple | None = None

    @property
    def full_hit(self) -> bool:
        return self.kind == "hit" and self.warped.full_hit


def plan_lookup(cache: RadianceCache | None, cam, acfg: ASDRConfig,
                prepared: RadiancePlan | None = None,
                device=None) -> RadiancePlan:
    """Decide (and, for hits, execute) the warp for this pose.  Pure:
    mutates nothing — re-run at admission to revalidate, where a still-
    matching ``prepared`` plan donates its warped arrays.  With
    ``device`` the warp runs there, on a copy of the entry's frame (a
    Stage A placed on another card than the cache's).

    Thread contract: the entry state (arrays + version) is snapshotted
    atomically under the cache lock; the warp itself — the expensive
    device work — runs OUTSIDE the lock on the snapshot, so worker-thread
    speculation never serializes against engine-thread commits."""
    with trace_lib.span("radiance.plan") as sp:
        plan = _plan_lookup(cache, cam, acfg, prepared, device)
        if sp is not trace_lib.NULL_SPAN:
            sp.attrs["kind"] = plan.kind
            if plan.reason is not None:
                sp.attrs["reason"] = plan.reason
        return plan


def _plan_lookup(cache, cam, acfg, prepared=None, device=None) -> RadiancePlan:
    if cache is None:
        return RadiancePlan("miss", "no_match")
    with cache.lock:
        match = cache._match(cam, acfg)
        if match is None:
            return RadiancePlan("miss", "no_match")
        entry, ang, tr = match
        k = cache.rcfg.refresh_every
        if k > 0 and entry.reuses_since_render >= k:
            return RadiancePlan("miss", "refresh", entry)
        shift = adaptive.reuse_dilation_radius(cam, ang, tr, scene.NEAR,
                                               margin=1.0)
        basis = (id(entry), entry.version, shift == 0)
        src_rgb, src_acc, src_depth = entry.rgb, entry.acc, entry.depth
        src_cam = entry.cam
        mark_stream_use(src_rgb, src_acc, src_depth)
    if device is not None:
        src_rgb, src_acc, src_depth = (
            t.to(device) for t in (src_rgb, src_acc, src_depth))
    if (prepared is not None and prepared.warped is not None
            and prepared.basis == basis):
        warped = prepared.warped
    elif shift == 0:
        warped = WarpedRadiance(
            src_rgb, torch.ones((cam.height * cam.width,), dtype=torch.bool,
                                device=src_rgb.device), 1.0)
    else:
        rgb, _acc, _depth, valid = warp_lib.warp_image(
            src_rgb, src_acc, src_depth, src_cam, cam)
        warped = WarpedRadiance(rgb, valid,
                                int(valid.sum()) / valid.numel())
    if shift != 0 and warped.valid_fraction < cache.rcfg.min_valid_fraction:
        return RadiancePlan("miss", "low_valid", entry, warped, basis)
    return RadiancePlan("hit", None, entry, warped, basis)


def commit_lookup(cache: RadianceCache | None,
                  plan: RadiancePlan) -> WarpedRadiance | None:
    """Apply the plan's bookkeeping; returns the warp to composite over
    (None = render fully).  The only mutating stage — engine thread only,
    under the cache lock."""
    if cache is None:
        return None
    with trace_lib.span("radiance.commit", kind=plan.kind), cache.lock:
        if plan.kind == "miss":
            if plan.reason == "refresh":
                cache.refreshes += 1
            elif plan.reason == "low_valid":
                cache.low_valid_misses += 1
            cache.misses += 1
            return None
        cache.hits += 1
        plan.entry.reuses_since_render += 1
        plan.entry.last_used = cache._tick()
        return plan.warped
