#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: ``python3 chip_smoke.py`` from the
root of a checkout, on a machine with one NVIDIA H100.

1. Builds the seven CUDA kernels from the five sources in
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (one nvcc per
   source, all started together).
2. Runs each kernel against its plain PyTorch version on the card, at the
   main path's shapes: the hash encode, density and color MLPs and the
   fused field (both chains in one kernel, also held bit for bit against
   the density -> color kernel pair) on the Phase-I probe samples of an
   800x800 frame (25,600 rays x 192), and the fused march on the frame's
   157 blocks of 4,096 rays with budgets drawn across the whole ladder
   (plain, density-only and per-ray exit).  Tolerance rtol 1e-4 / atol
   1e-5; the march's chunk counters exactly.
3. Renders the frame end to end at the paper's config
   (``configs/ingp_asdr.py`` CONFIG): the kernel path with
   ``march_backend="fused"`` (its launch counts are read from this run),
   the kernel field with the reference march, and the plain-torch field.
   The count maps of the kernel and plain paths may differ in at most
   0.1 % of pixels, and their PSNRs against the plain fixed-192 render
   of the same view by at most 0.1 dB.
4. Renders the §4.3 decoupled frame of the same view
   (``decouple.render_decoupled`` through the kernel field, in ray
   chunks), then composites its kept samples with one ``volume_render``
   launch over the whole frame (640,000 rays x 192 samples, 96 anchors),
   held against the plain version and against render_decoupled's image
   (rtol 1e-4 / atol 1e-5).  Prints the PSNR and SSIM of the decoupled
   frame and of the naive half-sample frame against the fixed-192 render.
5. Runs flash attention at gemma2-27b's attention widths (B 1, S 8,192,
   32 query heads over 16 KV heads, head_dim 128) for its local layer
   (window 4096, softcap 50), its global layer (softcap 50) and the global
   layer without softcap, in fp32 against the plain version (rtol 2e-4 /
   atol 2e-5), and the local layer in bf16 (3e-2).

Each phase's entry points run once with every launch count set to 0 just
before, and the run fails unless each kernel of that path launched.

The weights are random, drawn with numpy from ``SEED`` in the reference
layout: Glorot-uniform MLPs and hash tables uniform(-TABLE_SCALE,
TABLE_SCALE).  TABLE_SCALE = 30 makes the density chain's logits large, so
the frame holds several rungs of the count ladder and most Phase-II
blocks saturate before their budget (both asserted): the adaptive path and
the early-exit path both run.

Print lines start with ``[build]``, ``[kernel]``, ``[frame]``,
``[decoupled]`` and ``[attention]``.  Prints one ``{"kernels": [...]}``
line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 8
TABLE_SCALE = 30.0
CAMERA = dict(theta=0.9, phi=0.55)
RTOL, ATOL = 1e-4, 1e-5
ATTN_TOL = {"fp32": (2e-4, 2e-5), "bf16": (3e-2, 3e-2)}   # rtol, atol
MAX_COUNT_DIFF = 1e-3         # share of count-map pixels
MAX_PSNR_DIFF = 0.1           # dB
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3,
# and the dense bf16 tensor cores (stated beside attention's bound).
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_BF16_TC = 989e12
FRAME_KERNELS = ("hash_encode", "density_mlp", "color_mlp", "fused_march")
DECOUPLED_KERNELS = ("hash_encode", "density_mlp", "color_mlp",
                     "volume_render")
DECOUPLED_RAYS_PER_CALL = 1 << 16
ATTN_SEQ = 8192
# fp32 operations of one sample of the volume render: sigma*delta, two
# negations and two exps, 1 - e, the weight, the running sum, acc and the
# lerp offset (10), then per channel the lerp (3) and the weighted add (2).
VOLUME_RENDER_FLOP = 10 + 3 * 5
# fp32 operations of one trilinear encode of one point at one level:
# 3 scales + 3 fracs, then per corner 2 weight products and F
# multiply-adds (F = 2).
ENCODE_FLOP = 6 + 8 * (2 + 2 * 2)


def bound(flop: float, nbytes: float):
    t_ops, t_bytes = flop / PEAK_FP32, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def timed(fn, dev, reps: int):
    """(result, ms per call): CUDA events around ``reps`` calls after one
    warm-up call on the card; the host clock on the CPU."""
    import torch
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return out, start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return out, 1e3 * (time.perf_counter() - t0) / reps


def max_err(got, want, rtol=RTOL, atol=ATOL):
    """(max abs error, within rtol/atol), compared in fp32."""
    import torch
    got, want = got.float(), want.float()
    err = float(torch.max(torch.abs(got - want))) if got.numel() else 0.0
    return err, bool(torch.allclose(got, want, rtol=rtol, atol=atol))


def check(name, got, want, ms, plain_ms, flop, nbytes, library_ms=None,
          rtol=RTOL, atol=ATOL):
    """Print one kernel's reading, fail on disagreement, return it."""
    err, ok = max_err(got, want, rtol, atol)
    b_ms, b_by = bound(flop, nbytes)
    print(f"[kernel] {name}: max_abs_err={err:.3e} ms={ms:.3f} "
          f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.3f} ({b_by}) "
          f"library_ms={library_ms}", flush=True)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"(max abs err {err})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def kernel_row(name, src, replaces, *args, **kw):
    """The JSON row of one kernel (launches filled in from its path)."""
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": 0, **check(name, *args, **kw)}


def path_launches(names, fn):
    """``fn()`` with every launch count set to 0 just before; fails unless
    each kernel of ``names`` launched in it.  Returns (what fn returned,
    {name: launches})."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    counts = ops.launch_counts()
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was never launched on its path")
    return out, {name: counts[name] for name in names}


def check_kernels(field, bundle, cam, dev, reps=3):
    """Each kernel against its plain version at the main path's shapes.
    Returns the kernel rows of the JSON line (launches filled in later)
    and the fused field's launches on its path."""
    import numpy as np
    import torch
    from repro_torch.core import mlp as mlp_lib
    from repro_torch.core import pipeline, scene
    from repro_torch.kernels import fused_march as FMA
    from repro_torch.kernels import fused_mlp as FM
    from repro_torch.kernels import hash_encode as HE
    from repro_torch.kernels import ops

    acfg, net = bundle.asdr, bundle.model.net
    rows = []
    o, d = scene.camera_rays(cam, device=dev)
    st = acfg.probe_stride
    jj, ii = torch.meshgrid(torch.arange(0, cam.height, st, device=dev),
                            torch.arange(0, cam.width, st, device=dev),
                            indexing="ij")
    probe = (jj * cam.width + ii).reshape(-1)
    pts, _, _ = scene.sample_points(o[probe], d[probe], acfg.ns_full)
    pts = pts.reshape(-1, 3).contiguous()
    dirs = torch.repeat_interleave(d[probe], acfg.ns_full, dim=0)
    n = pts.shape[0]
    res = ops.FusedMarchResources(field)
    meta, tables = res.meta, res.tables
    L, T, F = tables.shape

    def row(*args, **kw):
        rows.append(kernel_row(*args, **kw))

    # ---- hash encode on the Phase-I samples
    enc, ms = timed(lambda: HE.hash_encode(pts, meta, tables), dev, reps)
    enc_p, plain_ms = timed(lambda: HE.hash_encode_plain(pts, meta, tables),
                            dev, 1)
    row("hash_encode", "hash_encode.cu", "src/repro/kernels/hash_encode.py:94",
        enc, enc_p, ms, plain_ms, flop=n * L * ENCODE_FLOP,
        nbytes=4 * (n * 3 + n * L * F + tables.numel() + meta.numel()))
    del enc_p

    # ---- density MLP on the same rows
    wd, dims_d = res.density
    ws_d = FM.unpack_chain(wd, dims_d)

    def density_matmul():
        h = torch.relu(enc @ ws_d[0])
        for w in ws_d[1:-1]:
            h = torch.relu(h @ w)
        out = h @ ws_d[-1]
        return torch.cat([FM.trunc_exp_plain(out[:, :1]), out[:, 1:]], 1)

    dout, ms = timed(lambda: FM.density_mlp(enc, wd, dims_d), dev, reps)
    dout_p, plain_ms = timed(lambda: FM.density_mlp_plain(enc, wd, dims_d),
                             dev, 1)
    _, lib_ms = timed(density_matmul, dev, reps)
    fl_d = mlp_lib.flops_per_sample(net)
    row("density_mlp", "fused_mlp.cu", "src/repro/kernels/fused_mlp.py:131",
        dout, dout_p, ms, plain_ms, flop=n * fl_d["density_flops"],
        nbytes=4 * (enc.numel() + dout.numel() + wd.numel()),
        library_ms=lib_ms)
    del dout_p

    # ---- color MLP on the same rows: [geo, SH(dir)]
    sh = mlp_lib.sh_encode(dirs, net.sh_degree).contiguous()
    cin = torch.cat([dout[:, 1:], sh], dim=-1).contiguous()
    wc, dims_c = res.color
    ws_c = FM.unpack_chain(wc, dims_c)

    def color_matmul():
        h = cin
        for w in ws_c[:-1]:
            h = torch.relu(h @ w)
        return torch.sigmoid(h @ ws_c[-1])

    rgb, ms = timed(lambda: FM.color_mlp(cin, wc, dims_c), dev, reps)
    rgb_p, plain_ms = timed(lambda: FM.color_mlp_plain(cin, wc, dims_c),
                            dev, 1)
    _, lib_ms = timed(color_matmul, dev, reps)
    row("color_mlp", "fused_mlp.cu", "src/repro/kernels/fused_mlp.py:145",
        rgb, rgb_p, ms, plain_ms, flop=n * fl_d["color_flops"],
        nbytes=4 * (cin.numel() + rgb.numel() + wc.numel()),
        library_ms=lib_ms)
    del rgb_p, cin

    # ---- fused field on the same rows: its entry point once, then the
    # kernel against its plain version and, bit for bit, against the
    # density -> color kernel pair above
    (sig_f, rgb_f, geo_f), ff_launches = path_launches(
        ("fused_field",), lambda: ops.fused_field(enc, dirs, res, net))
    pair_exact = (torch.equal(sig_f, dout[:, 0]) and torch.equal(rgb_f, rgb)
                  and torch.equal(geo_f, dout[:, 1:]))
    print(f"[kernel] fused_field: bit-equal to the density_mlp -> color_mlp "
          f"kernel pair: {pair_exact}", flush=True)
    if not pair_exact:
        raise AssertionError("fused_field differs from the density_mlp -> "
                             "color_mlp kernel pair")
    del sig_f, rgb_f, geo_f

    def fused_matmul():
        dm = density_matmul()
        h = torch.cat([dm[:, 1:], sh], 1)
        for w in ws_c[:-1]:
            h = torch.relu(h @ w)
        return torch.cat([dm[:, :1], torch.sigmoid(h @ ws_c[-1]), dm[:, 1:]],
                         1)

    ff, ms = timed(lambda: FM.fused_field(enc, sh, wd, dims_d, wc, dims_c),
                   dev, reps)
    ff_p, plain_ms = timed(
        lambda: FM.fused_field_plain(enc, sh, wd, dims_d, wc, dims_c), dev, 1)
    _, lib_ms = timed(fused_matmul, dev, reps)
    row("fused_field", "fused_mlp.cu", "src/repro/kernels/fused_mlp.py:116",
        ff, ff_p, ms, plain_ms,
        flop=n * (fl_d["density_flops"] + fl_d["color_flops"]),
        nbytes=4 * (enc.numel() + sh.numel() + ff.numel() + wd.numel()
                    + wc.numel()),
        library_ms=lib_ms)
    del ff, ff_p, enc, sh, rgb, dout, pts, dirs

    # ---- fused march on the frame's blocks, budgets across the ladder
    B, C = acfg.block_size, acfg.chunk
    R = cam.height * cam.width
    counts = torch.zeros((R,), dtype=torch.int32, device=dev)
    o_p, d_p, _, _, _ = pipeline.pad_rays_to_blocks(acfg, o, d, counts)
    nb = o_p.shape[0] // B
    ladder = sorted(set(acfg.candidates) | {acfg.ns_full})
    rng = np.random.default_rng(SEED)
    bud = np.concatenate([ladder, rng.choice(ladder, nb - len(ladder))])
    budgets = torch.from_numpy(bud.astype(np.int32)).to(dev)
    sh = mlp_lib.sh_encode(d_p, net.sh_degree).contiguous()
    common = dict(block_size=B, chunk=C, group=acfg.group, near=ops.NEAR32,
                  far=ops.FAR32, log_eps_t=ops.LOG_EPS_T32,
                  early_term=acfg.early_termination,
                  white_background=acfg.white_background)
    args = (o_p.contiguous(), d_p.contiguous())
    variants = [("", dict(with_color=True, per_ray_exit=False)),
                (" density_only", dict(with_color=False, per_ray_exit=False)),
                (" per_ray_early_exit", dict(with_color=True, per_ray_exit=True))]
    for tag, kw in variants:
        shv = sh if kw["with_color"] else None

        def kern():
            return FMA.fused_march(*args, shv, budgets, meta, tables, wd,
                                   dims_d, wc, dims_c, **common, **kw)

        def plain():
            return FMA.fused_march_plain(*args, shv, budgets, meta, tables,
                                         wd, dims_d, wc, dims_c, **common,
                                         **kw)

        out, ms = timed(kern, dev, reps if not tag else 1)
        out_p, plain_ms = timed(plain, dev, 1)
        exact_c = torch.equal(out[:, 5:7], out_p[:, 5:7])
        print(f"[kernel] fused_march{tag}: counters exact={exact_c}; "
              f"block chunks {out.reshape(nb, B, 8)[:, 0, 5].int().tolist()}",
              flush=True)
        if not exact_c:
            raise AssertionError(f"fused_march{tag}: chunk counters differ "
                                 "from the plain version")
        # work this run's data needs: valid samples of the chunks each
        # block ran (per live ray with per-ray exit), color on their anchors
        chunks_b = out.reshape(nb, B, 8)[:, :, 5].cpu().numpy()
        ray_c = out.reshape(nb, B, 8)[:, :, 6].cpu().numpy()
        samples = anchors = 0
        for bi in range(nb):
            runs = ray_c[bi] if kw["per_ray_exit"] else chunks_b[bi]
            for ci in range(int(runs.max())):
                v = max(0, min(C, int(bud[bi]) - ci * C))
                live = int((runs > ci).sum())
                samples += live * v
                anchors += live * -(-v // acfg.group)
        flop = samples * (L * ENCODE_FLOP + fl_d["density_flops"])
        if kw["with_color"]:
            flop += anchors * fl_d["color_flops"]
        nbytes = 4 * (2 * args[0].numel() + budgets.numel() + tables.numel()
                      + wd.numel() + wc.numel() + out.numel()
                      + (sh.numel() if kw["with_color"] else 0))
        if tag:
            check(f"fused_march{tag}", out, out_p, ms, plain_ms, flop, nbytes)
        else:
            row("fused_march", "fused_march.cu",
                "src/repro/kernels/fused_march.py:329", out, out_p, ms,
                plain_ms, flop, nbytes)
        del out, out_p
    return rows, ff_launches


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def render_frame(fns, acfg, cam, dev):
    """(image, stats, ms) of one render_asdr_image call, host clock around
    work that ends in a synchronize."""
    from repro_torch.core import pipeline

    sync(dev)
    t0 = time.perf_counter()
    img, st = pipeline.render_asdr_image(fns, acfg, cam, device=dev)
    sync(dev)
    return img, st, 1e3 * (time.perf_counter() - t0)


def fixed_reference(fns, cam, ns, dev, rays_per_call=1 << 15):
    import torch
    from repro_torch.core import pipeline, scene
    o, d = scene.camera_rays(cam, device=dev)
    rgb = torch.cat([pipeline.render_fixed_fns(fns, o[s:s + rays_per_call],
                                               d[s:s + rays_per_call], ns)[0]
                     for s in range(0, o.shape[0], rays_per_call)])
    return rgb.reshape(cam.height, cam.width, 3)


def run_frames(field, bundle, cam, dev):
    """The main path end to end; returns the launch counts of the fused
    frame and the plain fixed-``ns_full`` render of the view."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import model, pipeline, rendering
    from repro_torch.kernels import ops

    fns_k = ops.field_fns(field)
    fns_p = model.field_fns(field)
    fused = dataclasses.replace(bundle.asdr, march_backend="fused")
    reference = dataclasses.replace(bundle.asdr, march_backend="reference")

    (img_k, st_k, ms_k), launches = path_launches(
        FRAME_KERNELS, lambda: render_frame(fns_k, fused, cam, dev))
    print(f"[frame] kernel path, fused march: {ms_k:.1f} ms (first run); "
          f"launches {launches}", flush=True)
    _, _, ms_k2 = render_frame(fns_k, fused, cam, dev)
    sync(dev)
    t0 = time.perf_counter()
    pipeline.probe_phase(fns_k, fused, cam, device=dev)
    sync(dev)
    ms_probe = 1e3 * (time.perf_counter() - t0)
    img_r, st_r, ms_r = render_frame(fns_k, reference, cam, dev)
    img_p, st_p, ms_p = render_frame(fns_p, reference, cam, dev)
    print(f"[frame] kernel path, fused march (second run): {ms_k2:.1f} ms, "
          f"of which Phase I alone {ms_probe:.1f} ms; kernel field, "
          f"reference march: {ms_r:.1f} ms; plain field, reference march: "
          f"{ms_p:.1f} ms", flush=True)

    counts = st_k["counts"]
    vals, nums = torch.unique(counts, return_counts=True)
    hist = dict(zip(vals.tolist(), nums.tolist()))
    budgets = st_k["budgets"].cpu().numpy()
    chunks = st_k["chunks_per_block"].cpu().numpy()
    full = -(-budgets // bundle.asdr.chunk)
    early = int((chunks < full).sum())
    print(f"[frame] count histogram {hist}", flush=True)
    print(f"[frame] budgets {np.unique(budgets, return_counts=True)[0].tolist()}"
          f" x {np.unique(budgets, return_counts=True)[1].tolist()}; "
          f"chunks per block {chunks.tolist()}; {early} of {len(chunks)} "
          f"blocks exit early; samples {st_k['samples_processed']} of "
          f"{st_k['baseline_samples']}", flush=True)
    if len(hist) < 2:
        raise AssertionError("the count map holds a single ladder value")
    if early < 1:
        raise AssertionError("no Phase-II block exited early")

    diff = float((st_k["counts"] != st_p["counts"]).float().mean())
    diff_r = float((st_r["counts"] != st_p["counts"]).float().mean())
    ref = fixed_reference(fns_p, cam, bundle.asdr.ns_full, dev)
    p_k = float(rendering.psnr(img_k, ref))
    p_r = float(rendering.psnr(img_r, ref))
    p_p = float(rendering.psnr(img_p, ref))
    chunks_eq = bool(torch.equal(st_k["chunks_per_block"],
                                 st_r["chunks_per_block"]))
    print(f"[frame] count-map share differing from the plain path: kernel "
          f"{diff:.3e}, reference march {diff_r:.3e}; PSNR vs plain "
          f"fixed-{bundle.asdr.ns_full}: fused {p_k:.4f} dB, reference march "
          f"{p_r:.4f} dB, plain {p_p:.4f} dB; fused and reference chunks "
          f"equal: {chunks_eq}", flush=True)
    if not (all(math.isfinite(x) for x in (p_k, p_r, p_p))
            and bool(torch.isfinite(img_k).all())
            and tuple(img_k.shape) == (cam.height, cam.width, 3)):
        raise AssertionError("non-finite or misshapen frame")
    if diff > MAX_COUNT_DIFF or diff_r > MAX_COUNT_DIFF:
        raise AssertionError(f"count maps differ in {diff:.3e} / {diff_r:.3e}"
                             f" of pixels (limit {MAX_COUNT_DIFF})")
    if abs(p_k - p_p) > MAX_PSNR_DIFF or abs(p_r - p_p) > MAX_PSNR_DIFF:
        raise AssertionError(f"PSNR gap {p_k - p_p:.4f} / {p_r - p_p:.4f} dB "
                             f"(limit {MAX_PSNR_DIFF})")
    return launches, ref


def run_decoupled(field, bundle, cam, ref, dev, reps=3):
    """The §4.3 decoupled frame through the kernel field in ray chunks,
    then one volume_render launch on its kept samples.  Returns the
    volume_render row and its launches on the path."""
    import torch
    from repro_torch.core import decouple, rendering, scene
    from repro_torch.kernels import ops
    from repro_torch.kernels import volume_render as VR

    acfg = bundle.asdr
    S, g, wb = acfg.ns_full, acfg.group, acfg.white_background
    H, W = cam.height, cam.width
    R, step = H * W, DECOUPLED_RAYS_PER_CALL
    fns = ops.field_fns(field)
    o, d = scene.camera_rays(cam, device=dev)

    def frame():
        parts = [decouple.render_decoupled(fns, o[s:s + step], d[s:s + step],
                                           S, group=g, white_background=wb,
                                           keep_samples=True)
                 for s in range(0, R, step)]
        rgb = torch.cat([p[0] for p in parts])
        kept = [torch.cat([p[1][k] for p in parts])
                for k in ("sigmas", "anchor_colors", "deltas")]
        del parts
        vr_rgb, _ = ops.volume_render(*kept, g, white_background=wb)
        return rgb, kept, vr_rgb

    sync(dev)
    t0 = time.perf_counter()
    (rgb, (sig, anch, dl), vr_rgb), launches = path_launches(
        DECOUPLED_KERNELS, frame)
    sync(dev)
    ms_frame = 1e3 * (time.perf_counter() - t0)
    A = anch.shape[1]
    print(f"[decoupled] frame (render_decoupled in chunks of {step} rays, "
          f"then volume_render on R={R} S={S} A={A}): {ms_frame:.1f} ms; "
          f"launches {launches}", flush=True)

    err_f, ok_f = max_err(vr_rgb, rgb)
    print(f"[decoupled] volume_render rgb vs render_decoupled rgb: "
          f"max_abs_err={err_f:.3e}", flush=True)
    if not ok_f:
        raise AssertionError(f"volume_render's frame differs from "
                             f"render_decoupled's (max abs err {err_f})")
    out, ms = timed(lambda: VR.volume_render(sig, dl, anch, g), dev, reps)
    out_p, plain_ms = timed(lambda: VR.volume_render_plain(sig, dl, anch, g),
                            dev, 1)
    print(f"[decoupled] volume_render bit-equal to its plain version: "
          f"{torch.equal(out, out_p)}", flush=True)
    row = kernel_row("volume_render", "volume_render.cu",
                     "src/repro/kernels/volume_render.py:75", out, out_p, ms,
                     plain_ms, flop=VOLUME_RENDER_FLOP * R * S,
                     nbytes=4 * (2 * R * S + 3 * R * A + 4 * R))
    del out, out_p, sig, anch, dl, vr_rgb

    naive = torch.cat([decouple.render_naive_reduced(
        fns, o[s:s + step], d[s:s + step], S, factor=2)
        for s in range(0, R, step)])
    saved = decouple.mlp_flops_saved(bundle.model, S, g)
    for tag, img in ((f"decoupled group {g}", rgb), (f"naive {S // 2} samples",
                                                     naive)):
        img = img.reshape(H, W, 3)
        p, q = float(rendering.psnr(img, ref)), float(rendering.ssim(img, ref))
        print(f"[decoupled] {tag} vs plain fixed-{S}: PSNR {p:.4f} dB, "
              f"SSIM {q:.5f}", flush=True)
        if not (math.isfinite(p) and math.isfinite(q)
                and bool(torch.isfinite(img).all())):
            raise AssertionError(f"{tag}: non-finite frame")
    print(f"[decoupled] MLP FLOPs saved by decoupling (analytic): "
          f"{saved['reduction_fraction']:.4f}", flush=True)
    return row, {"volume_render": launches["volume_render"]}


def run_attention(cfg, seq, dev, reps=3):
    """Flash attention at ``cfg``'s attention widths on one sequence of
    ``seq`` tokens: the local layer, the global layer, the global layer
    without softcap (the library's case) in fp32, the local layer in bf16.
    Returns the no-softcap row and the kernel's launches on the path."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    B, S, H, KV, Dh = 1, seq, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(SEED)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .to(dev) for shape in ((B, S, H, Dh), (B, S, KV, Dh),
                                      (B, S, KV, Dh)))
    bf16 = tuple(t.to(torch.bfloat16) for t in (q, k, v))
    settings = [("local", (q, k, v), cfg.window, cfg.attn_softcap),
                ("global", (q, k, v), 0, cfg.attn_softcap),
                ("global no softcap", (q, k, v), 0, 0.0),
                ("local bf16", bf16, cfg.window, cfg.attn_softcap)]
    outs, launches = path_launches(("flash_attention",), lambda: [
        FA.flash_attention(*x, window=w, softcap=c) for _, x, w, c in settings])
    row = None
    for (tag, x, w, c), out in zip(settings, outs):
        rtol, atol = ATTN_TOL["bf16" if x[0].dtype == torch.bfloat16 else "fp32"]
        _, ms = timed(lambda: FA.flash_attention(*x, window=w, softcap=c), dev,
                      reps)
        want, plain_ms = timed(lambda: FA.flash_attention_plain(*x, w, c),
                               dev, 1)
        pairs = sum(min(i + 1, w or S) for i in range(S))
        flop = 4 * Dh * B * H * pairs
        nbytes = x[0].element_size() * 2 * (x[0].numel() + x[1].numel())
        lib_ms = None
        if tag == "global no softcap":
            qt, kt, vt = (t.transpose(1, 2) for t in x)
            lib, lib_ms = timed(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), dev, reps)
            print(f"[attention] scaled_dot_product_attention vs the kernel: "
                  f"max_abs_err={max_err(lib.transpose(1, 2), out)[0]:.3e}",
                  flush=True)
            del lib
        print(f"[attention] {tag} (window {w}, softcap {c}, "
              f"{x[0].dtype}): {pairs} causal pairs, {flop / 1e9:.1f} GFLOP; "
              f"bound on the dense bf16 tensor cores "
              f"{1e3 * flop / PEAK_BF16_TC:.3f} ms", flush=True)
        args = (out, want, ms, plain_ms, flop, nbytes)
        if tag == "global no softcap":
            row = kernel_row("flash_attention", "flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:86", *args,
                             library_ms=lib_ms, rtol=rtol, atol=atol)
        else:
            check(f"flash_attention {tag}", *args, rtol=rtol, atol=atol)
        del want
    return row, launches


def run(dev, bundle, hw, attn, seq, reps=3):
    """Phases 2-5 on ``dev`` at ``bundle``, image size ``hw``, attention
    widths ``attn`` and ``seq`` tokens; returns the kernel rows of the JSON
    line."""
    from repro_torch import params
    from repro_torch.core import scene

    field = params.from_jax_params(
        params.random_params(bundle.model, SEED, TABLE_SCALE), bundle.model,
        device=dev)
    cam = scene.look_at_camera(hw[0], hw[1], **CAMERA)
    rows, launches = check_kernels(field, bundle, cam, dev, reps)
    frame_launches, ref = run_frames(field, bundle, cam, dev)
    vr_row, vr_launches = run_decoupled(field, bundle, cam, ref, dev, reps)
    fa_row, fa_launches = run_attention(attn, seq, dev, reps)
    rows += [vr_row, fa_row]
    launches.update(**frame_launches, **vr_launches, **fa_launches)
    for r in rows:
        r["launches"] = launches[r["name"]]
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import gemma2_27b, ingp_asdr
    from repro_torch.kernels import _build

    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(built)}",
          flush=True)
    for name, info in built.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    bundle = ingp_asdr.CONFIG
    rows = run(dev, bundle, bundle.image_hw, gemma2_27b.CONFIG, ATTN_SEQ)
    print(json.dumps({"kernels": rows}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
