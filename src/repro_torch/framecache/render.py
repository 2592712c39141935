"""Single-image rendering through the full cross-frame reuse stack
(``repro.framecache.render``).

``render_asdr_image_cached`` is ``core.pipeline.render_asdr_image`` plus a
per-scene ``FrameCache``: Phase I goes through the warped probe cache,
Phase II first asks the radiance cache for a warp of a nearby finished
frame and marches only the disoccluded rays, through the scene-space block
tier when one is plugged in.  It runs on ``device`` (the GPU unless
``device="cpu"``); the frame is assembled there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core import pipeline, scene
from ..core.fields import FieldFns
from ..core.pipeline import ASDRConfig
from ..device import resolve_device
from ..scenecache import SceneBlockCache
from ..scenecache.render import render_adaptive_cached
from .probe import ProbeCache, ProbeReuseConfig, cached_probe_maps
from .radiance import RadianceCache, RadianceReuseConfig


@dataclasses.dataclass
class FrameCache:
    """The per-scene reuse state: probe maps + finished radiance.

    ``scene`` optionally plugs in the scene-space block tier
    (``scenecache``) — unlike the two pose tiers it may be SHARED between
    FrameCaches of different scenes/users (block keys carry the scene id);
    ``scene_id`` names this scene inside that shared store.
    """
    probe: Optional[ProbeCache] = None
    radiance: Optional[RadianceCache] = None
    scene: Optional[SceneBlockCache] = None
    scene_id: str = "scene"


def make_frame_cache(
    probe_cfg: ProbeReuseConfig | None = ProbeReuseConfig(),
    radiance_cfg: RadianceReuseConfig | None = RadianceReuseConfig(),
    scene_cache: SceneBlockCache | None = None,
    scene_id: str = "scene",
) -> FrameCache:
    """Build the per-scene reuse state.

    ``scene_cache`` takes an already-constructed ``SceneBlockCache``: the
    caller owns the shared store's lifetime.  Block keys disambiguate
    scenes only by ``scene_id``, so a shared store needs an explicit id.
    """
    if scene_cache is not None and scene_id == "scene":
        raise ValueError(
            "make_frame_cache(scene_cache=...) requires an explicit "
            "scene_id: block keys disambiguate scenes ONLY by this id, so "
            "two scenes sharing a store under the default would serve "
            "each other's cached blocks")
    return FrameCache(
        probe=ProbeCache(probe_cfg) if probe_cfg is not None else None,
        radiance=(RadianceCache(radiance_cfg)
                  if radiance_cfg is not None else None),
        scene=scene_cache,
        scene_id=scene_id,
    )


def render_asdr_image_cached(fns: FieldFns, acfg: ASDRConfig, cam,
                             fc: FrameCache | None = None, probe_jitter=None,
                             device=None):
    """Two-phase ASDR render with cross-frame reuse.

    Returns (image (H,W,3), stats).  With fc=None this is
    ``pipeline.render_asdr_image`` (modulo the always-on opacity sort key).
    Stats gain: probe_reused, probe_skipped, radiance_reused, rays_marched,
    rays_total, warp_valid_fraction, scene_block_hits, scene_block_misses,
    samples_reused, and ``counts``, the frame's count map (None when Phase
    I was skipped), as ``render_asdr_image`` returns it.

    The radiance lookup runs BEFORE Phase I, and a full warp hit (every
    pixel valid) skips the probe outright, booked on the probe cache
    (``ProbeCache.note_skip``).
    """
    dev = resolve_device(device)
    H, W = cam.height, cam.width
    R = H * W
    fc = fc or FrameCache()
    warped = fc.radiance.lookup(cam, acfg) if fc.radiance is not None else None
    probe_skipped = warped is not None and warped.full_hit
    if probe_skipped:
        # zero disoccluded rays: nobody reads the count/opacity maps, so
        # Phase I is pure waste — skip it without aging the probe cache
        if fc.probe is not None:
            fc.probe.note_skip()
        maps, probe_reused = None, False
    else:
        maps, probe_reused = cached_probe_maps(
            fns, acfg, cam, fc.probe, probe_jitter, device=dev)
    o, d = scene.camera_rays(cam, device=dev)

    if warped is None:
        o_p, d_p, c_p, op_p, _pad = pipeline.pad_rays_to_blocks(
            acfg, o, d, maps.counts, maps.opacity)
        rgb, acc, stats = render_adaptive_cached(
            fns, acfg, o_p, d_p, c_p, op_p, fc.scene, fc.scene_id)
        img_flat = rgb[:R]
        # stored under the MARCH's per-ray termination depth (sharper than
        # the probe's stride-d proxy at depth edges, and pose-aligned even
        # when a dilation-mode probe reuse left maps.depth = None)
        if fc.radiance is not None:
            fc.radiance.store(cam, acfg, rgb[:R], acc[:R],
                              stats["term_depth"][:R])
        rays_marched, valid_fraction = R, 0.0
        stats = dict(stats)
    else:
        march_idx = (~warped.valid).nonzero().flatten()
        n_march = int(march_idx.numel())
        img_flat = warped.rgb.clone()
        stats = {"samples_processed": 0,
                 "samples_reused": 0, "baseline_samples": 0,
                 "scene_block_hits": 0, "scene_block_misses": 0}
        if n_march:
            o_p, d_p, c_p, op_p, _pad = pipeline.pad_rays_to_blocks(
                acfg, o[march_idx], d[march_idx], maps.counts[march_idx],
                maps.opacity[march_idx])
            rgb, _acc, stats = render_adaptive_cached(
                fns, acfg, o_p, d_p, c_p, op_p, fc.scene, fc.scene_id)
            stats = dict(stats)
            img_flat[march_idx] = rgb[:n_march]
        # rays delivered straight from the warp count as REUSED compute
        # at the fixed-march baseline rate (the baseline_samples
        # convention) — zero-march frames must not vanish from the split
        stats["samples_reused"] = (int(stats.get("samples_reused", 0))
                                   + (R - n_march) * acfg.ns_full)
        rays_marched, valid_fraction = n_march, warped.valid_fraction

    stats["counts"] = None if maps is None else maps.counts
    stats["probe_samples"] = 0 if maps is None else maps.cost
    stats["probe_reused"] = probe_reused
    stats["probe_skipped"] = probe_skipped
    stats["radiance_reused"] = warped is not None
    stats["rays_marched"] = rays_marched
    stats["rays_total"] = R
    stats["warp_valid_fraction"] = valid_fraction
    return img_flat.reshape(H, W, 3), stats
