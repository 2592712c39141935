"""The plain reference of ASDR's two-phase frame (the paper's §4.2-4.3).

Phase I probes every ``probe_stride``-th pixel at ``ns_full`` samples,
re-composites the same samples at each candidate count by striding, gives
each probe ray the smallest count whose colour differs from the full
render by at most ``delta`` (Eq. 3), interpolates the counts bilinearly
to every pixel and snaps them up to the ladder.  Phase II sorts the rays
by count (stable) into blocks of ``block_size``, and marches each block
chunk by chunk for ``ceil(budget / chunk)`` chunks, or fewer once every
ray of the block has saturated (transmittance under 1e-4); the colour MLP
runs on every ``group``-th sample and the others lerp between anchors.

A frozen copy of the plain path of the port's ``core/`` (scene,
rendering, adaptive, decouple, pipeline), on the reference field of
``ngp.py``; it imports nothing of the program.  Float32 throughout.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEAR, FAR = 0.2, 2.2
EARLY_TERM_TRANSMITTANCE = 1e-4
LOG_EPS_T = math.log(EARLY_TERM_TRANSMITTANCE)
MARCH_SAMPLES_PER_CALL = 1 << 21


def linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """float32 ``start * (1 - i r) + i (stop r)``, r = 1 / (num - 1)."""
    div = num - 1
    i = np.arange(div, dtype=np.float32)
    s, e = np.float32(start), np.float32(stop)
    r = np.float32(1.0) / np.float32(div)
    body = s * (np.float32(1.0) - i * r) + i * (e * r)
    out = np.concatenate([body, np.asarray([e], np.float32)])
    return torch.from_numpy(out).to(device)


def camera_rays(cam, device):
    """(origins (H*W, 3), unit dirs (H*W, 3)) of a pinhole camera."""
    j, i = torch.meshgrid(
        torch.arange(cam.height, dtype=torch.float32, device=device),
        torch.arange(cam.width, dtype=torch.float32, device=device),
        indexing="ij")
    x = (i - cam.width * 0.5 + 0.5) / cam.focal
    y = -(j - cam.height * 0.5 + 0.5) / cam.focal
    rot = torch.from_numpy(np.asarray(cam.c2w_rot, np.float32)).to(device)
    d = x[..., None] * rot[:, 0] + y[..., None] * rot[:, 1] + rot[:, 2]
    a, b, c = d[..., :1], d[..., 1:2], d[..., 2:]
    d = d / torch.sqrt((a * a + b * b + c * c).double()).float()
    o = torch.from_numpy(np.asarray(cam.origin, np.float32)).to(device)
    return o.expand(d.shape).reshape(-1, 3), d.reshape(-1, 3)


def alphas_from_sigmas(sigmas, deltas):
    return 1.0 - torch.exp(-sigmas * deltas)


def composite(sigmas, colors, deltas, white_background=True):
    alphas = alphas_from_sigmas(sigmas, deltas)
    log_t = torch.cumsum(torch.log(torch.clamp(1.0 - alphas, 1e-10, 1.0)),
                         dim=-1)
    log_t = torch.cat([torch.zeros_like(log_t[..., :1]), log_t[..., :-1]],
                      dim=-1)
    weights = torch.exp(log_t) * alphas
    rgb = torch.sum(weights[..., None] * colors, dim=-2)
    acc = torch.sum(weights, dim=-1)
    if white_background:
        rgb = rgb + (1.0 - acc[..., None])
    return rgb, acc


def render_fixed(field, origins, dirs, n_samples: int, white_background):
    """Midpoint samples at a fixed count; returns (rgb, sigmas, colors)."""
    R = origins.shape[0]
    edges = linspace(NEAR, FAR, n_samples + 1, origins.device)
    ts = (0.5 * (edges[:-1] + edges[1:]))[None, :].expand(R, n_samples)
    deltas = torch.full((R, n_samples), (FAR - NEAR) / n_samples,
                        device=origins.device)
    pts = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
    sigma, geo = field.density(pts.reshape(-1, 3))
    color = field.color(geo, torch.repeat_interleave(dirs, n_samples, dim=0))
    sigma = sigma.reshape(R, n_samples)
    color = color.reshape(R, n_samples, 3)
    rgb, _ = composite(sigma, color, deltas, white_background)
    return rgb, sigma, color


def probe_counts(sigmas, colors, rgb_full, ns_full, candidates, delta):
    counts = torch.full((rgb_full.shape[0],), ns_full, dtype=torch.int32,
                        device=rgb_full.device)
    for ns_i in sorted(candidates, reverse=True):
        stride = ns_full // ns_i
        sub_s = sigmas[:, ::stride][:, :ns_i]
        sub_c = colors[:, ::stride][:, :ns_i]
        deltas = torch.full(sub_s.shape, (FAR - NEAR) / ns_i,
                            device=sigmas.device)
        rgb_i, _ = composite(sub_s, sub_c, deltas)
        rd = torch.max(torch.abs(rgb_full - rgb_i), dim=-1).values
        counts = torch.where(rd <= delta, ns_i, counts).to(torch.int32)
    return counts


def interpolate_counts(probe, probe_hw, full_hw, ladder):
    ph, pw = probe_hw
    H, W = full_hw
    dev = probe.device
    grid = probe.reshape(ph, pw).to(torch.float32)
    ys = linspace(0.0, ph - 1.0, H, dev)
    xs = linspace(0.0, pw - 1.0, W, dev)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, ph - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, pw - 1)
    y1 = torch.clamp(y0 + 1, 0, ph - 1)
    x1 = torch.clamp(x0 + 1, 0, pw - 1)
    wy = (ys - y0.to(torch.float32))[:, None]
    wx = (xs - x0.to(torch.float32))[None, :]
    v = (grid[y0][:, x0] * (1 - wy) * (1 - wx)
         + grid[y0][:, x1] * (1 - wy) * wx
         + grid[y1][:, x0] * wy * (1 - wx)
         + grid[y1][:, x1] * wy * wx).reshape(H * W)
    lad = torch.tensor(ladder, dtype=torch.int32, device=dev)
    idx = torch.searchsorted(lad, torch.ceil(v).to(torch.int32), side="left")
    return lad[torch.clamp(idx, 0, lad.shape[0] - 1)]


def interpolate_group_colors(anchor_colors, n: int, S: int):
    R, A, _ = anchor_colors.shape
    j = torch.arange(S, device=anchor_colors.device)
    gi = j // n
    t = (j % n).to(anchor_colors.dtype) / float(n)
    left = anchor_colors[:, torch.clamp(gi, 0, A - 1)]
    right = anchor_colors[:, torch.clamp(gi + 1, 0, A - 1)]
    return left + (right - left) * t[None, :, None]


def march_blocks(field, a: dict, origins, dirs, budget):
    """Blocks (N, B, 3) with budgets (N,) -> (rgb (N,B,3), depth (N,B),
    chunks (N,), ray_chunks (N,B))."""
    N, B, _ = origins.shape
    C, group = a["chunk"], a["group"]
    dev = origins.device
    budget = budget.to(torch.int32)
    delta_t = torch.full((N,), FAR - NEAR, device=dev) / budget.float()
    n_chunks = (budget + C - 1) // C
    log_t = torch.zeros((N, B), device=dev)
    rgb = torch.zeros((N, B, 3), device=dev)
    acc = torch.zeros((N, B), device=dev)
    dep = torch.zeros((N, B), device=dev)
    ray_chunks = torch.zeros((N, B), dtype=torch.int32, device=dev)
    chunks = torch.zeros((N,), dtype=torch.int32, device=dev)
    a_idx = torch.arange(0, C, group, device=dev)
    A = a_idx.shape[0]
    for ci in range(int(n_chunks.max()) if N else 0):
        run = (ci < n_chunks) & torch.any(log_t > LOG_EPS_T, dim=1)
        act = torch.nonzero(run).flatten()
        if act.numel() == 0:
            break
        n = act.numel()
        lt = log_t[act]
        alive = lt > LOG_EPS_T
        idx = ci * C + torch.arange(C, device=dev)
        valid = idx[None, :] < budget[act, None]
        ts = NEAR + (idx.float()[None, :] + 0.5) * delta_t[act, None]
        pts = (origins[act, :, None, :]
               + ts[:, None, :, None] * dirs[act, :, None, :])
        sigma, geo = field.density(pts.reshape(-1, 3))
        sigma = torch.where(valid[:, None, :], sigma.reshape(n, B, C), 0.0)
        geo_a = geo.reshape(n, B, C, -1)[:, :, a_idx].reshape(n * B * A, -1)
        dirs_a = torch.repeat_interleave(dirs[act].reshape(-1, 3), A, dim=0)
        col_a = field.color(geo_a, dirs_a).reshape(n * B, A, 3)
        colors = interpolate_group_colors(col_a, group, C).reshape(n, B, C, 3)
        alphas = alphas_from_sigmas(sigma, delta_t[act, None, None])
        log_steps = torch.log(torch.clamp(1.0 - alphas, 1e-10, 1.0))
        intra = torch.cumsum(log_steps, dim=-1) - log_steps
        w = torch.exp(lt[..., None] + intra) * alphas
        rgb[act] = rgb[act] + torch.sum(w[..., None] * colors, dim=2)
        acc[act] = acc[act] + torch.sum(w, dim=-1)
        dep[act] = dep[act] + torch.sum(w * ts[:, None, :], dim=-1)
        log_t[act] = lt + torch.sum(log_steps, dim=-1)
        ray_chunks[act] = ray_chunks[act] + alive.to(torch.int32)
        chunks[act] = chunks[act] + 1
    depth = dep + (1.0 - acc) * FAR
    if a["white_background"]:
        rgb = rgb + (1.0 - acc[..., None])
    return rgb, depth, chunks, ray_chunks


def render_frame(field, cfg: dict, cam, device):
    """The frame of ``cam``: (image (H, W, 3), stats) with the stats the
    comparison reads: ``counts`` (H*W,), ``budgets`` and
    ``chunks_per_block`` (blocks,), ``ray_chunks_per_block`` (blocks, B)
    and ``term_depth`` (padded rays,) in pixel order, and
    ``probe_samples``."""
    a = cfg["asdr"]
    H, W = cam.height, cam.width
    B, st, ns = a["block_size"], a["probe_stride"], a["ns_full"]
    ladder = sorted(set(a["candidates"]) | {ns})
    o, d = camera_rays(cam, device)
    # ---- Phase I
    jj, ii = torch.meshgrid(torch.arange(0, H, st, device=device),
                            torch.arange(0, W, st, device=device),
                            indexing="ij")
    pidx = (jj * W + ii).reshape(-1)
    rgb_full, sig, col = render_fixed(field, o[pidx], d[pidx], ns,
                                      a["white_background"])
    pcounts = probe_counts(sig, col, rgb_full, ns, a["candidates"],
                           a["delta"])
    del sig, col
    counts = interpolate_counts(pcounts, tuple(jj.shape), (H, W), ladder)
    # ---- Phase II: pad to whole blocks, sort, march, unsort
    R = H * W
    pad = (-R) % B
    if pad:
        o = torch.cat([o, torch.zeros((pad, 3), device=device)])
        d = torch.cat([d, torch.tensor([[0.0, 0.0, 1.0]],
                                       device=device).expand(pad, 3)])
    cp = torch.cat([counts, torch.full((pad,), min(a["candidates"]),
                                       dtype=torch.int32, device=device)])
    order = torch.argsort(cp, stable=True)
    budgets = cp[order].reshape(-1, B).max(dim=1).values
    o_s, d_s = o[order].reshape(-1, B, 3), d[order].reshape(-1, B, 3)
    step = max(1, MARCH_SAMPLES_PER_CALL // (B * a["chunk"]))
    parts = [march_blocks(field, a, o_s[s:s + step], d_s[s:s + step],
                          budgets[s:s + step])
             for s in range(0, o_s.shape[0], step)]
    rgb_s, depth_s, chunks, ray_chunks = (torch.cat(p) for p in zip(*parts))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(R + pad, device=device)
    img = rgb_s.reshape(-1, 3)[inv][:R].reshape(H, W, 3)
    stats = {"counts": counts, "budgets": budgets,
             "chunks_per_block": chunks, "ray_chunks_per_block": ray_chunks,
             "term_depth": depth_s.reshape(-1)[inv],
             "probe_samples": int(pidx.shape[0]) * ns}
    return img, stats
