#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: ``python3 chip_smoke.py`` from the
root of a checkout, on a machine with one NVIDIA H100.

1. Builds the four CUDA kernels from the three sources in
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (one nvcc per
   source, all started together).
2. Runs each kernel against its plain PyTorch version on the card, at the
   main path's shapes: the hash encode, density and color MLPs on the
   Phase-I probe samples of an 800x800 frame (25,600 rays x 192), and the
   fused march on the frame's 157 blocks of 4,096 rays with budgets drawn
   across the whole ladder (plain, density-only and per-ray exit).
   Tolerance rtol 1e-4 / atol 1e-5; the march's chunk counters exactly.
3. Renders the frame end to end at the paper's config
   (``configs/ingp_asdr.py`` CONFIG): the kernel path with
   ``march_backend="fused"`` (its launch counts are read from this run),
   the kernel field with the reference march, and the plain-torch field.
   The count maps of the kernel and plain paths may differ in at most
   0.1 % of pixels, and their PSNRs against the plain fixed-192 render
   of the same view by at most 0.1 dB.

The weights are random, drawn with numpy from ``SEED`` in the reference
layout: Glorot-uniform MLPs and hash tables uniform(-TABLE_SCALE,
TABLE_SCALE).  TABLE_SCALE = 30 makes the density chain's logits large, so
the frame holds several rungs of the count ladder and most Phase-II
blocks saturate before their budget (both asserted): the adaptive path and
the early-exit path both run.

Prints one ``{"kernels": [...]}`` line, the card's name and power limit,
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
MAX_COUNT_DIFF = 1e-3         # share of count-map pixels
MAX_PSNR_DIFF = 0.1           # dB
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
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


def max_err(got, want):
    """(max abs error, within rtol/atol)."""
    import torch
    err = float(torch.max(torch.abs(got - want))) if got.numel() else 0.0
    return err, bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))


def check_kernels(field, bundle, cam, dev, reps=3):
    """Each kernel against its plain version at the main path's shapes.
    Returns the kernel rows of the JSON line (launches filled in later)."""
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

    def check(name, got, want, ms, plain_ms, flop, nbytes, library_ms=None):
        """Print one kernel's reading, fail on disagreement, return it."""
        err, ok = max_err(got, want)
        b_ms, b_by = bound(flop, nbytes)
        print(f"[kernel] {name}: max_abs_err={err:.3e} ms={ms:.3f} "
              f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.3f} ({b_by}) "
              f"library_ms={library_ms}", flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"(max abs err {err})")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}

    def row(name, src, replaces, *args, **kw):
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}",
                     "replaces": replaces, "launches": 0,
                     **check(name, *args, **kw)})

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
    cin = torch.cat([dout[:, 1:], mlp_lib.sh_encode(dirs, net.sh_degree)],
                    dim=-1).contiguous()
    del enc
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
    del rgb_p, cin, dout, pts, dirs

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
    return rows


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
    frame."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import model, pipeline, rendering
    from repro_torch.kernels import ops

    fns_k = ops.field_fns(field)
    fns_p = model.field_fns(field)
    fused = dataclasses.replace(bundle.asdr, march_backend="fused")
    reference = dataclasses.replace(bundle.asdr, march_backend="reference")

    ops.reset_launch_counts()
    img_k, st_k, ms_k = render_frame(fns_k, fused, cam, dev)
    launches = ops.launch_counts()
    print(f"[frame] kernel path, fused march: {ms_k:.1f} ms (first run); "
          f"launches {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
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
    return launches


def run(dev, bundle, hw, reps=3):
    """Phases 2 and 3 on ``dev`` at ``bundle`` and image size ``hw``;
    returns the kernel rows of the JSON line."""
    from repro_torch import params
    from repro_torch.core import scene

    field = params.from_jax_params(
        params.random_params(bundle.model, SEED, TABLE_SCALE), bundle.model,
        device=dev)
    cam = scene.look_at_camera(hw[0], hw[1], **CAMERA)
    rows = check_kernels(field, bundle, cam, dev, reps)
    launches = run_frames(field, bundle, cam, dev)
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
    from repro_torch.configs import ingp_asdr
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
    rows = run(dev, bundle, bundle.image_hw)
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
