"""The two-phase ASDR renderer (``repro.core.pipeline``).

Phase I  — probe every d-th pixel at full ``ns``; derive per-pixel sample
           counts (adaptive.py).
Phase II — sort rays into difficulty-homogeneous blocks; march each block
           chunk by chunk for ``ceil(block_budget / chunk)`` chunks, or
           fewer when every ray of the block has saturated.  Within a
           chunk the color MLP runs only on every ``group``-th sample
           (decouple.py).

Written against the ``FieldFns`` protocol (fields.py), so the same code
renders the plain-torch NGP, the analytic scenes and the CUDA-kernel
field; ``march_backend="fused"`` sends Phase II to the single-kernel
march (kernels/fused_march.py) when the field carries its resources.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..device import resolve_device
from . import adaptive, decouple, rendering, scene
from .fields import FieldFns

LOG_EPS_T = math.log(rendering.EARLY_TERM_TRANSMITTANCE)

# Samples the reference march evaluates per field call: blocks are
# marched side by side in groups of at most this many samples per chunk.
MARCH_SAMPLES_PER_CALL = 1 << 21


@dataclasses.dataclass(frozen=True)
class ASDRConfig:
    ns_full: int = 192
    probe_stride: int = 5            # paper's d
    delta: float = 1.0 / 2048.0      # paper's best threshold (Fig. 21a)
    candidates: Tuple[int, ...] = adaptive.DEFAULT_CANDIDATES
    group: int = 2                   # color-decoupling group size n
    block_size: int = 256            # rays per Phase-II block
    chunk: int = 16                  # samples per march iteration
    early_termination: bool = True
    white_background: bool = True
    # Secondary block-sort key: probe-interpolated opacity, so saturating
    # rays share blocks and whole blocks exit early.
    sort_by_opacity: bool = False
    # "reference" = chunked density/color calls per chunk (this module);
    # "fused" = the single-kernel march when the FieldFns carries
    # fused-march resources (fields without them keep the reference).
    march_backend: str = "reference"
    # Table supply of the fused march.  Accepted and validated for the
    # reference's sake ("auto" | "resident" | "streamed"); on the GPU there
    # is one supply — the tables stay in device memory and gathers go
    # through L2 — so all three values mean the same.
    march_table_streaming: str = "auto"
    # Per-RAY early exit: saturated rays stop contributing sample work
    # (their sigma is masked); chunk counters are unchanged by the flag.
    per_ray_early_exit: bool = False


def render_fixed_fns(fns: FieldFns, origins, dirs, n_samples: int,
                     jitter=None, white_background: bool = True):
    """Baseline fixed-count renderer over a FieldFns (paper's "original").

    ``jitter``: optional (R, n_samples) uniform [0, 1) draws for
    stratified sampling (scene.sample_points).
    """
    pts, deltas, ts = scene.sample_points(origins, dirs, n_samples, jitter)
    R, S = pts.shape[:2]
    flat = pts.reshape(-1, 3)
    dflat = torch.repeat_interleave(dirs, S, dim=0)
    sigma, geo = fns.density(flat)
    color = fns.color(geo, dflat)
    sigma = sigma.reshape(R, S)
    color = color.reshape(R, S, 3)
    rgb, acc, weights = rendering.composite(
        sigma, color, deltas, white_background=white_background)
    aux = {"sigmas": sigma, "colors": color, "deltas": deltas, "ts": ts,
           "acc": acc, "weights": weights}
    return rgb, aux


def _march_block(fns: FieldFns, acfg: ASDRConfig, origins, dirs, budget,
                 density_only: bool = False):
    """March blocks of rays, each with its own sample budget.

    origins/dirs: (N, B, 3); budget: (N,) int32.  Each block is marched
    exactly as on its own: chunk ``ci`` runs while ``ci < ceil(budget /
    chunk)`` and (with early termination) some ray of that block is still
    live.  Returns (rgb (N,B,3), acc (N,B), depth (N,B), chunks_done (N,)
    int32, ray_chunks (N,B) int32) — depth is ``E[t] + (1 - acc) * FAR``
    and ray_chunks counts the chunks each ray entered still live.

    With ``density_only`` the color MLP never runs and rgb stays zero.
    """
    N, B, _ = origins.shape
    C = acfg.chunk
    dev = origins.device
    budget = budget.to(torch.int32)
    delta_t = torch.full((N,), scene.FAR - scene.NEAR, device=dev) / budget.float()
    n_chunks = (budget + C - 1) // C

    log_t = torch.zeros((N, B), device=dev)
    rgb = torch.zeros((N, B, 3), device=dev)
    acc = torch.zeros((N, B), device=dev)
    dep = torch.zeros((N, B), device=dev)
    ray_chunks = torch.zeros((N, B), dtype=torch.int32, device=dev)
    chunks = torch.zeros((N,), dtype=torch.int32, device=dev)
    a_idx = torch.arange(0, C, acfg.group, device=dev)
    A = a_idx.shape[0]
    for ci in range(int(n_chunks.max()) if N else 0):
        run = ci < n_chunks
        if acfg.early_termination:
            run = run & torch.any(log_t > LOG_EPS_T, dim=1)
        act = torch.nonzero(run).flatten()
        if act.numel() == 0:
            break
        n = act.numel()
        lt = log_t[act]
        alive = lt > LOG_EPS_T
        idx = ci * C + torch.arange(C, device=dev)
        valid = idx[None, :] < budget[act, None]                 # (n, C)
        ts = scene.NEAR + (idx.float()[None, :] + 0.5) * delta_t[act, None]
        pts = origins[act, :, None, :] + ts[:, None, :, None] * dirs[act, :, None, :]
        sigma, geo = fns.density(pts.reshape(-1, 3))
        sigma = torch.where(valid[:, None, :], sigma.reshape(n, B, C), 0.0)
        if acfg.per_ray_early_exit:
            sigma = torch.where(alive[..., None], sigma, 0.0)
        if not density_only:
            geo_a = geo.reshape(n, B, C, -1)[:, :, a_idx].reshape(n * B * A, -1)
            dirs_a = torch.repeat_interleave(dirs[act].reshape(-1, 3), A, dim=0)
            col_a = fns.color(geo_a, dirs_a).reshape(n * B, A, 3)
            colors = decouple.interpolate_group_colors(
                col_a, acfg.group, C).reshape(n, B, C, 3)
        alphas = rendering.alphas_from_sigmas(sigma, delta_t[act, None, None])
        log_steps = torch.log(torch.clamp(1.0 - alphas, 1e-10, 1.0))
        intra = torch.cumsum(log_steps, dim=-1) - log_steps      # exclusive
        w = torch.exp(lt[..., None] + intra) * alphas
        if not density_only:
            rgb[act] = rgb[act] + torch.sum(w[..., None] * colors, dim=2)
        acc[act] = acc[act] + torch.sum(w, dim=-1)
        dep[act] = dep[act] + torch.sum(w * ts[:, None, :], dim=-1)
        log_t[act] = lt + torch.sum(log_steps, dim=-1)
        ray_chunks[act] = ray_chunks[act] + alive.to(torch.int32)
        chunks[act] = chunks[act] + 1
    depth = dep + (1.0 - acc) * scene.FAR
    if acfg.white_background and not density_only:
        rgb = rgb + (1.0 - acc[..., None])
    return rgb, acc, depth, chunks, ray_chunks


def march_blocks(fns: FieldFns, acfg: ASDRConfig, o_b, d_b, budgets,
                 density_only: bool = False):
    """March a batch of blocks: o_b/d_b (N, B, 3), budgets (N,) int32 ->
    (rgb (N,B,3), acc (N,B), depth (N,B), chunks (N,), ray_chunks (N,B)).

    The backend seam for Phase II: with ``march_backend == "fused"`` and a
    FieldFns carrying fused-march resources (kernels.ops.field_fns), the
    whole batch runs as ONE kernel launch; otherwise the chunked reference
    march above runs over groups of blocks.  Both keep the same
    early-termination contract (identical chunks_done).
    """
    if acfg.march_backend == "fused" and fns.fused is not None:
        from ..kernels import ops as _kops  # lazy: core stays kernel-free
        return _kops.fused_march_blocks(
            fns.fused, acfg, o_b, d_b, budgets, density_only=density_only)
    N, B, _ = o_b.shape
    step = max(1, MARCH_SAMPLES_PER_CALL // (B * acfg.chunk))
    outs = [_march_block(fns, acfg, o_b[s:s + step], d_b[s:s + step],
                         budgets[s:s + step], density_only=density_only)
            for s in range(0, N, step)]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def block_sort(acfg: ASDRConfig, counts, opacity=None):
    """Sort rays into difficulty-homogeneous blocks: (order, budgets).
    counts: (R,) int32 with R % block_size == 0."""
    B = acfg.block_size
    if acfg.sort_by_opacity and opacity is not None:
        # composite key: count (primary), quantized opacity (secondary)
        key = counts.to(torch.int32) * 1024 + torch.clamp(
            (opacity * 1023).to(torch.int32), 0, 1023)
        order = torch.argsort(key, stable=True).to(torch.int32)
        budgets = counts[order].reshape(-1, B).max(dim=1).values
        return order, budgets
    return adaptive.sort_rays_into_blocks(counts, B)


def pad_rays_to_blocks(acfg: ASDRConfig, origins, dirs, counts, opacity=None):
    """Pad rays to a block_size multiple with minimum-count dummy rays
    pointing +z from the origin corner; callers crop to the first R rows.
    Returns (origins, dirs, counts, opacity, pad)."""
    R = origins.shape[0]
    dev = origins.device
    pad = (-R) % acfg.block_size
    if pad:
        origins = torch.cat([origins, torch.zeros((pad, 3), device=dev)])
        dirs = torch.cat([dirs, torch.tensor([[0.0, 0.0, 1.0]],
                                             device=dev).expand(pad, 3)])
        counts = torch.cat([counts, torch.full((pad,), min(acfg.candidates),
                                               dtype=torch.int32, device=dev)])
        if opacity is not None:
            opacity = torch.cat([opacity, torch.zeros((pad,), device=dev)])
    return origins, dirs, counts, opacity, pad


def render_adaptive(fns: FieldFns, acfg: ASDRConfig, origins, dirs, counts,
                    opacity=None):
    """Phase II: sorted-block adaptive render.

    origins/dirs (R, 3) with R % block_size == 0; counts (R,) int32;
    opacity: optional (R,) secondary sort key.  Returns (rgb (R,3),
    acc (R,), stats).
    """
    R = origins.shape[0]
    B = acfg.block_size
    order, budgets = block_sort(acfg, counts, opacity)
    o_s = origins[order].reshape(-1, B, 3)
    d_s = dirs[order].reshape(-1, B, 3)
    rgb_s, acc_s, depth_s, chunks, ray_chunks = march_blocks(
        fns, acfg, o_s, d_s, budgets)
    inv = torch.zeros_like(order)
    inv[order.long()] = torch.arange(R, dtype=order.dtype, device=order.device)
    inv = inv.long()
    stats = {
        "samples_processed": int(torch.sum(chunks)) * B * acfg.chunk,
        "baseline_samples": R * acfg.ns_full,
        "chunks_per_block": chunks,
        "ray_chunks_per_block": ray_chunks,
        "budgets": budgets,
        "term_depth": depth_s.reshape(R)[inv],
    }
    return rgb_s.reshape(R, 3)[inv], acc_s.reshape(R)[inv], stats


def probe_phase(fns: FieldFns, acfg: ASDRConfig, cam, probe_jitter=None,
                return_opacity: bool = False, return_depth: bool = False,
                device=None):
    """Phase I: strided probe -> per-pixel sample-count map (H*W,).

    With return_opacity, also the bilinearly interpolated probe opacity;
    with return_depth, additionally the interpolated expected termination
    depth (background pinned to FAR)."""
    H, W = cam.height, cam.width
    o, d = scene.camera_rays(cam, device=device)
    dev = o.device
    st = acfg.probe_stride
    jj, ii = torch.meshgrid(torch.arange(0, H, st, device=dev),
                            torch.arange(0, W, st, device=dev), indexing="ij")
    probe_idx = (jj * W + ii).reshape(-1)
    rgb_full, aux = render_fixed_fns(
        fns, o[probe_idx], d[probe_idx], acfg.ns_full, probe_jitter,
        white_background=acfg.white_background)
    pcounts = adaptive.probe_counts(aux["sigmas"], aux["colors"], rgb_full,
                                    acfg.ns_full, acfg.candidates, acfg.delta)
    probe_hw = (jj.shape[0], jj.shape[1])
    counts = adaptive.interpolate_counts(pcounts, probe_hw, (H, W),
                                         acfg.candidates, acfg.ns_full)
    probe_cost = int(probe_idx.shape[0]) * acfg.ns_full
    if not (return_opacity or return_depth):
        return counts, probe_cost
    opacity = adaptive.interpolate_map(aux["acc"], probe_hw, (H, W))
    if not return_depth:
        return counts, probe_cost, opacity
    t_exp = rendering.expected_termination_depth(
        aux["weights"], aux["ts"], aux["acc"], scene.FAR)
    depth = adaptive.interpolate_map(t_exp, probe_hw, (H, W))
    return counts, probe_cost, opacity, depth


def render_asdr_image(fns: FieldFns, acfg: ASDRConfig, cam,
                      probe_jitter=None, device=None):
    """Full two-phase ASDR render of a camera view on ``device`` (the GPU
    unless ``device="cpu"``).  Returns (image (H,W,3), stats dict)."""
    dev = resolve_device(device)
    H, W = cam.height, cam.width
    o, d = scene.camera_rays(cam, device=dev)
    opacity = None
    if acfg.sort_by_opacity:
        counts, probe_cost, opacity = probe_phase(
            fns, acfg, cam, probe_jitter, return_opacity=True, device=dev)
    else:
        counts, probe_cost = probe_phase(fns, acfg, cam, probe_jitter,
                                         device=dev)
    # ---- Phase II ----
    R = H * W
    o, d, counts, opacity, _pad = pad_rays_to_blocks(acfg, o, d, counts,
                                                     opacity)
    rgb, acc, stats = render_adaptive(fns, acfg, o, d, counts, opacity)
    img = rgb[:R].reshape(H, W, 3)
    stats = dict(stats)
    stats.update(adaptive.compute_savings(counts[:R], acfg.ns_full))
    stats["counts"] = counts[:R]
    stats["probe_samples"] = probe_cost
    stats["phase2_fraction_of_baseline"] = (
        stats["samples_processed"] / stats["baseline_samples"])
    return img, stats
