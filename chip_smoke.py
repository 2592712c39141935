#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: ``python3 chip_smoke.py`` from the
root of a checkout, on a machine with one NVIDIA H100.

1. Builds the seven CUDA kernels from the five sources in
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (one nvcc per
   source, all started together).  ptxas must report a 0-byte stack frame
   and no spills for the hash encode, the four register-tiled kernels
   (density MLP, color MLP, fused field, fused march), the volume render
   and both flash-attention instantiations (bf16, fp32), whose registers
   it prints; the density, march and volume-render launchers must ask for
   the shared memory their wrappers reckon, and the flash-attention
   launcher must use the wrapper's tiles, shared memory and grid.
2. Runs each kernel against its plain PyTorch version on the card, at the
   main path's shapes: the hash encode, density and color MLPs and the
   fused field (both chains in one kernel, also held bit for bit against
   the density -> color kernel pair) on the Phase-I probe samples of an
   800x800 frame (25,600 rays x 192), and the fused march on the frame's
   157 blocks of 4,096 rays with budgets drawn across the whole ladder
   (plain, density-only and per-ray exit, each held on all 157 blocks),
   then once more at a ragged shape
   (blocks of 1,000 rays, group 3, budgets below the chunk, per-ray exit).
   The density MLP, color MLP, fused field and fused march must match
   their plain versions at max abs error 0 (the color chains' plain
   versions emulate fmaf; the MLPs' run in chunks of ``PLAIN_ROWS``
   rows), the march's chunk counters with them; the color MLP also on a
   ragged, unaligned slice.  The hash encode at max abs error 0, on the
   Phase-I rows and on one decoupled chunk's rows (65,536 rays x 192),
   timed as the median of ``TIME_ROUNDS`` rounds of ``TIME_REPS``
   launches with the L2 warm and after a ``FLUSH_BYTES`` flush, with the
   card's clocks and power sampled beside; the distinct 32-B sectors its
   warps' gathers touch are reckoned for its level-group mapping and the
   point-major one it replaced.
3. Renders the frame end to end at the paper's config
   (``configs/ingp_asdr.py`` CONFIG): the kernel path with
   ``march_backend="fused"`` (its launch counts are read from this run),
   the kernel field with the reference march, and the plain-torch field;
   then times the fused march alone on the frame's own blocks and budgets
   (with and without color), beside the bound of the work they needed.
   The count maps of the kernel and plain paths may differ in at most
   0.1 % of pixels, and their PSNRs against the plain fixed-192 render of
   the same view by at most 0.1 dB.
4. Renders the §4.3 decoupled frame of the same view
   (``decouple.render_decoupled`` through the kernel field, in ray
   chunks; a second run under ``torch.profiler`` gives each kernel's
   device time and the device's idle share), then composites its kept
   samples with one ``volume_render`` launch over the whole frame
   (640,000 rays x 192 samples, 96 anchors),
   held against the plain version bit for bit and against
   render_decoupled's image (rtol 1e-4 / atol 1e-5), then at the
   ``RAGGED_RENDERS`` shapes (rays off the warp, samples off the chunk,
   one anchor, group 3; also one float off 16-B alignment), bit for bit.
   Prints the PSNR and SSIM of the decoupled frame and of the naive
   half-sample frame against the fixed-192 render.
5. Runs flash attention at gemma2-27b's attention widths (B 1, S 8,192,
   32 query heads over 16 KV heads, head_dim 128) for its local layer
   (window 4096, softcap 50), its global layer (softcap 50) and the global
   layer without softcap, in fp32 against the plain version (rtol 2e-4 /
   atol 2e-5), and the local layer and the global layer without softcap
   in bf16 (rtol 1e-2 / atol 8e-3, and the error's norm at most 3e-3 of
   the output's), the bf16 bounds on the tensor cores and on the
   special-function units; times ``scaled_dot_product_attention`` on both
   no-softcap settings; then at ``RAGGED_SEQ`` tokens, head_dim 64, H / KV
   1 and 8, in both dtypes, global and windowed with the softcap.

6. ``[train]``: trains the paper-width NGP (``CONFIG.model``) on the card
   with ``core/train.py: train_ngp`` on the lego scene: ``TRAIN_STEPS``
   steps of 4,096 rays x 48 samples from 24 views of 200x200, lr 5e-3 on
   the cosine schedule, autograd through the plain field; prints the
   median ms a step after the first ``TRAIN_WARM_STEPS`` (each step ends
   in a synchronize, as the loss is read every step), the loss at the
   first and last step and the peak memory, and fails unless the loss
   falls below ``TRAIN_LOSS_GATE`` of its first value with every trained
   tensor finite; runs ``TRAIN_PROFILE_STEPS`` more steps under
   ``torch.profiler`` (device time by kernel, kernels launched, idle
   share).  Then renders the trained scene at the 800x800 view:
   the analytic ground truth (512 samples), the fixed-192 frame through
   the kernel field built from the trained field (chunks of 32,768 rays)
   and the two-phase frame (kernel field, fused march), each timed on
   the host clock around a synchronised second run; prints both PSNRs
   against ground truth, the ASDR frame's against fixed-192, the gap, the
   count histogram and budgets, the samples spent (Phase II plus the
   probe) against 640,000 x 192, and the fixed-192 / ASDR time ratio
   beside the paper's software-only GPU figure (Fig. 24, AS 1.84x), and
   by count rung the share of pixels, of the ASDR frame's squared error
   and of its excess over fixed-192's.  The
   same frame on the plain field may differ from the kernel path's in at
   most 0.1 % of count-map pixels and 0.1 dB of PSNR against ground
   truth.

7. ``[reuse]``: ASDR's cross-frame data reuse on the trained field:
   ``render_asdr_image_cached`` over ``TRAJ_POSES`` 800x800 poses (theta
   0.9 + 0.01 k, phi 0.55) through the kernel field with the fused march
   and all tiers (warped probe maps, warped radiance, a shared
   ``SceneBlockCache``).  Per frame: ms, rays marched, the reuse flags,
   the warp's valid share, block hits and misses, samples processed and
   reused, PSNR against a fresh ``render_asdr_image`` of the pose and
   against the analytic ground truth; then the trajectory's ms beside the
   same poses rendered fresh.  Gates: (a) frame 0, all tiers cold, equals
   ``render_asdr_image`` bit for bit, image and count map; (b) the plain
   field's trajectory has the same flags, rays marched and count maps
   within 0.1 % and PSNRs against ground truth within 0.1 dB; (c) the
   trajectory with a ``Tracer`` installed gives the same frames and stats
   bit for bit, the reuse spans, and an export ``tools/check_trace.py``
   passes; (d) a replay with radiance reuse off on the same block store
   hits every block left resident and gives each frame the first pass
   marched whole back bit for bit.

8. ``[serve]``: the render serving engine (``serve.RenderServingEngine``)
   over two scenes at the paper's widths, both through the kernel field
   and the fused march: the trained lego field and the random field of
   phases 2-4.  Three viewers, closed loop, 24 requests enqueued k-major
   (viewers 0 and 1 on lego, viewer 2 on the random field, each at the
   ``[reuse]`` orbit's first ``SERVE_POSES`` poses); the engine at the
   reference's defaults (slots 4, blocks of 16 a batch, prefetch 2) with
   every reuse tier on and a 32 MiB block store.  Readings a run (host
   clock, synchronised): wall ms and frames/s, latency and admission
   stall p50/p99, a round's march ms p50/p99, batches and the pad-block
   fraction, rays marched, reused probe and radiance fractions, block
   hit rate, the store's resident bytes and evictions, the weight-pack
   LRU's hits, misses and size, launches; the same requests one by one
   through ``render_asdr_image``; runs with two worker streams, two
   batches in flight and blocks of 64 a batch; the full configuration
   with Stage A inline and on two worker streams under ``torch.profiler``.
   Gates, each fatal: (a) with every tier off and no prefetch, each
   request's image, samples and probe samples equal
   ``render_asdr_image``'s bit for bit; (b) frames and
   ``DETERMINISTIC_COUNTERS`` bit-identical at prefetch 0, prefetch 2 and
   two worker streams, and with every tier off at two batches in flight
   (with the tiers on, batches in flight move when frames finish and so
   what later admissions find cached, in the reference too: printed, not
   gated); (c) traced with worker streams, the same frames and counters,
   an export ``tools/check_trace.py`` passes, ``executor.run`` on
   ``serve-stage-a`` lanes, dispatch and collect batch ids matching; (d)
   viewer 0 alone on the plain field: equal flags and rays marched,
   samples within 0.1 %, PSNR against ground truth within 0.1 dB; (e)
   with the block store alone, a second viewer replaying the first's
   ``SERVE_REPLAY_POSES`` poses marches nothing and gets its frames bit
   for bit.

Each phase's entry points run once with every launch count set to 0 just
before, and the run fails unless each kernel of that path launched (for
``[train]``, the two trained frames together; for ``[reuse]``, the
trajectory; for ``[serve]``, the main run).

Phases 2-5 use random weights, drawn with numpy from ``SEED`` in the
reference layout: Glorot-uniform MLPs and hash tables
uniform(-TABLE_SCALE, TABLE_SCALE).  TABLE_SCALE = 30 makes the density
chain's logits large, so the frame holds several rungs of the count
ladder and most Phase-II blocks saturate before their budget (both
asserted): the adaptive path and the early-exit path both run.

Print lines start with ``[build]``, ``[kernel]``, ``[frame]``,
``[decoupled]``, ``[attention]``, ``[train]``, ``[reuse]`` and
``[serve]``.  Prints one
``{"kernels": [...]}`` line, the card's name and power limit,
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
# Flash attention against its plain version: rtol, atol and a limit on
# ||got - want|| / ||want||.  bf16 is held at 2-3x its error on the card
# (max 3.9e-3, one bf16 step of the output; norm 0.8-1.0e-3); the norm
# limit catches a few keys lost or added across the late rows, whose
# outputs are ~0.02.
ATTN_TOL = {"fp32": (2e-4, 2e-5, None), "bf16": (1e-2, 8e-3, 3e-3)}
MAX_COUNT_DIFF = 1e-3         # share of count-map pixels
MAX_PSNR_DIFF = 0.1           # dB
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3,
# and the dense bf16 tensor cores (stated beside attention's bound).
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_BF16_TC = 989e12
# The special-function units (exp2, reciprocal): 16 results a clock per SM
# (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0) on 132 SMs at the 1,980 MHz boost clock (data sheet).
PEAK_SFU = 16 * 132 * 1.98e9
FRAME_KERNELS = ("hash_encode", "density_mlp", "color_mlp", "fused_march")
# The [train] phase: the paper-width NGP trained on the card on the lego
# scene (24 views of 200x200, 4,096 rays x 48 samples a batch, lr 5e-3 on
# the cosine schedule), then rendered at CAMERA.  A step is bound by the
# host's launches (~4,800 kernels, the device idle ~80 % of the time) and
# took 63-97 ms on an H100, so 800 steps stay within ~80 s of training.
# The phase fails unless the loss falls below TRAIN_LOSS_GATE of its
# first value (the reference's own gate, tests/test_ngp_train.py).
TRAIN_STEPS = 800
TRAIN = dict(scene="lego", steps=TRAIN_STEPS, batch_rays=4096, n_samples=48,
             lr=5e-3, n_views=24, view_hw=(200, 200), seed=0, log_every=1)
TRAIN_LOSS_GATE = 0.4
TRAIN_WARM_STEPS = 10          # steps left out of the median step time
TRAIN_PROFILE_STEPS = 20       # steps under torch.profiler after training
GT_RAYS_PER_CALL = 1 << 14     # ground truth: 512 analytic samples a ray
# The paper's software-only GPU figure for adaptive sampling alone (Fig.
# 24, "AS"): a reading to print beside the card's ratio, not a target.
PAPER_AS_SPEEDUP = 1.84
# The [reuse] phase: ASDR's cross-frame data reuse over a camera trajectory
# on the trained field: TRAJ_POSES poses at theta 0.9 + TRAJ_STEP k, phi
# 0.55, 0.57 degrees and ~0.010 of eye travel a step.  Frames 1-3 warp
# frame 0's radiance (under RadianceReuseConfig's 2 degrees / 0.04),
# frame 4 is past it and marches afresh on a warped probe (under the
# probe's 4 degrees / 0.08), and the probe's refresh_every = 8 re-probes
# at frame 9.  The plain field's trajectory (gate (b)) takes most of the
# phase, ~2.5 s a full frame; all TRAJ_POSES of it fit the phase's ~60 s.
TRAJ_POSES = 12
TRAJ_STEP = 0.01
REUSE_FLAGS = ("probe_reused", "probe_skipped", "radiance_reused")
REUSE_SPANS = ("probe.plan", "probe.execute", "probe.commit",
               "warp.count_map", "warp.image", "radiance.plan",
               "radiance.commit", "scenecache.store")
DECOUPLED_KERNELS = ("hash_encode", "density_mlp", "color_mlp",
                     "volume_render")
DECOUPLED_RAYS_PER_CALL = 1 << 16
# The fma-emulating plain versions of the tile kernels run in row chunks:
# one float64 temporary of a 4,915,200 x 128 layer step would be 5 GB.
PLAIN_ROWS = 1 << 20
# The kernels ptxas must give a 0-byte stack frame and no spills (the
# hash encode's instantiations, the register-tiled chains, the volume
# render and both flash-attention instantiations), with their sources.
TILE_KERNELS = {"hash_encode_kernel": "hash_encode",
                "color_mlp_kernel": "fused_mlp",
                "fused_field_kernel": "fused_mlp",
                "density_mlp_kernel": "fused_mlp",
                "fused_march_kernel": "fused_march",
                "volume_render_kernel": "volume_render",
                "flash_attention_bf16_kernel": "flash_attention",
                "flash_attention_f32_kernel": "flash_attention"}
# The ragged march: blocks of a size that is not a multiple of 32, group
# 3, budgets below the chunk among them, per-ray exit.
RAGGED_B, RAGGED_GROUP = 1000, 3
RAGGED_BUDGETS = (7, 20, 31, 12, 96, 192, 5, 48, 24, 33, 65, 100)
# Ragged attention: a length that is a multiple of neither query tile and
# a window whose first key falls mid-tile.
RAGGED_SEQ, RAGGED_WINDOW = 333, 100
# Ragged volume render (R, S, A, group): rays off the warp's 32, samples
# off the chunk (S % 4 != 0 and == 0), one anchor or a group's worth.
RAGGED_RENDERS = ((1005, 50, 1, 3), (1005, 50, 17, 3), (1005, 52, 18, 3))
ATTN_SEQ = 8192
# fp32 operations of one sample of the volume render: sigma*delta, two
# negations and two exps, 1 - e, the weight, the running sum, acc and the
# lerp offset (10), then per channel the lerp (3) and the weighted add (2).
VOLUME_RENDER_FLOP = 10 + 3 * 5
# The hash encode's timing: the median of TIME_ROUNDS rounds of TIME_REPS
# launches, warm, and each launch after FLUSH_BYTES written (the tables
# cold in L2, as a decoupled chunk's launch finds them after the color
# MLP); nvidia-smi samples the card every SMI_MS ms beside the window.
TIME_ROUNDS, TIME_REPS = 5, 10
FLUSH_BYTES = 256 << 20
SMI_QUERY = "clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
SMI_MS = 100
# fp32 operations of one trilinear encode of one point at one level:
# 3 scales + 3 fracs, then per corner 2 weight products and F
# multiply-adds (F = 2).
ENCODE_FLOP = 6 + 8 * (2 + 2 * 2)


def bound(flop: float, nbytes: float, peak: float = PEAK_FP32):
    """(ms, "operations" or "bytes"): the larger of ``flop`` at ``peak``
    and ``nbytes`` at the memory rate."""
    t_ops, t_bytes = flop / peak, nbytes / PEAK_BYTES
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


def timed_rounds(fn, dev, flush=None, rounds=TIME_ROUNDS, reps=TIME_REPS):
    """ms per call of each of ``rounds`` rounds of ``reps`` calls after a
    warm-up call: CUDA events around each round's calls, or, where a
    ``flush`` tensor is given, around each call alone, after ``flush`` is
    overwritten (outside the events) so each call finds the L2 cold.  The
    host clock on the CPU."""
    import torch
    fn()
    out = []
    for _ in range(rounds):
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out.append(1e3 * (time.perf_counter() - t0) / reps)
            continue
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(reps if flush is not None else 1)]
        torch.cuda.synchronize(dev)
        if flush is None:
            ev[0][0].record()
            for _ in range(reps):
                fn()
            ev[0][1].record()
        else:
            for start, end in ev:
                flush.zero_()
                start.record()
                fn()
                end.record()
        torch.cuda.synchronize(dev)
        out.append(sum(a.elapsed_time(b) for a, b in ev) / reps)
    return out


def spread(ms):
    """'median (min-max over n rounds)' of per-round times."""
    s = sorted(ms)
    return (f"{s[len(s) // 2]:.3f} ({s[0]:.3f}-{s[-1]:.3f} over {len(s)} "
            f"rounds)")


class SmiSampler:
    """nvidia-smi sampling the card's clocks, power and temperature every
    SMI_MS ms while the ``with`` block runs (nothing off the card)."""

    def __init__(self, dev):
        self.dev, self.rows = dev, []

    def __enter__(self):
        import threading
        if self.dev.type != "cuda":
            return self
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", f"--query-gpu={SMI_QUERY}",
             "--format=csv,noheader,nounits", "-lms", str(SMI_MS)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=lambda: self.rows.extend(
            [float(x) for x in line.split(",")] for line in self.proc.stdout
            if line.count(",") == 4), daemon=True)
        self.reader.start()
        return self

    def wait_for_samples(self, n=2, limit_s=5.0):
        """Block until ``n`` samples came in (at most ``limit_s``)."""
        t0 = time.perf_counter()
        while (self.dev.type == "cuda" and len(self.rows) < n
               and time.perf_counter() - t0 < limit_s):
            time.sleep(0.01)

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            self.proc.terminate()
            self.proc.wait()
            self.reader.join()

    def summary(self) -> str:
        if not self.rows:
            return "card not sampled"
        cols = list(zip(*self.rows))
        rng = [f"{min(c):g}-{max(c):g}" for c in cols]
        return (f"{len(self.rows)} nvidia-smi samples: SM clock {rng[0]} MHz, "
                f"memory clock {rng[1]} MHz, power draw {rng[2]} W of "
                f"{rng[3]} W limit, {rng[4]} C")


def max_err(got, want, rtol=RTOL, atol=ATOL):
    """(max abs error, within rtol/atol), compared in fp32."""
    import torch
    got, want = got.float(), want.float()
    err = float(torch.max(torch.abs(got - want))) if got.numel() else 0.0
    return err, bool(torch.allclose(got, want, rtol=rtol, atol=atol))


def rel_norm_err(got, want) -> float:
    """||got - want|| / ||want||, in fp32."""
    import torch
    got, want = got.float(), want.float()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def in_chunks(fn, *rows, rest=(), step=PLAIN_ROWS):
    """fn(*chunk of each of ``rows``, *rest), concatenated over row chunks
    of at most ``step``."""
    import torch
    return torch.cat([fn(*(r[s:s + step] for r in rows), *rest)
                      for s in range(0, rows[0].shape[0], step)])


def check(name, got, want, ms, plain_ms, flop, nbytes, library_ms=None,
          rtol=RTOL, atol=ATOL, exact=False, peak=PEAK_FP32, rel=None):
    """Print one kernel's reading, fail on disagreement (any at all where
    ``exact``; a relative norm of the error above ``rel`` where given),
    return it."""
    err, ok = max_err(got, want, rtol, atol)
    ok = ok and (err == 0.0 or not exact)
    rel_txt = ""
    if rel is not None:
        r = rel_norm_err(got, want)
        ok = ok and r <= rel
        rel_txt = f" rel_norm_err={r:.3e} (limit {rel})"
    b_ms, b_by = bound(flop, nbytes, peak)
    print(f"[kernel] {name}: max_abs_err={err:.3e}{rel_txt} ms={ms:.3f} "
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


def march_reckoning(runs, budgets, res, acfg, fl_d, with_color):
    """The work one fused-march run needed, from its chunk counters: the
    valid samples of each chunk each ray ran and their anchors, and the
    operations and bytes of its bound.  ``runs`` (nb, B) holds the chunks
    each ray ran (its block's, where rays do not exit on their own),
    ``budgets`` (nb,).  Returns (samples, anchors, flop, nbytes)."""
    import numpy as np
    from repro_torch.kernels import fused_march as FMA

    runs, bud = np.asarray(runs), np.asarray(budgets).astype(np.int64)
    nb, B = runs.shape
    C = acfg.chunk
    samples = anchors = 0
    for ci in range(int(runs.max(initial=0))):
        v = np.clip(bud - ci * C, 0, C)
        live = (runs > ci).sum(axis=1)
        samples += int((live * v).sum())
        anchors += int((live * -(-v // acfg.group)).sum())
    L = res.tables.shape[0]
    flop = samples * (L * ENCODE_FLOP + fl_d["density_flops"])
    if with_color:
        flop += anchors * fl_d["color_flops"]
    sh_dim = res.net.sh_dim if with_color else 0
    nbytes = 4 * (nb * B * (2 * 3 + FMA.OUT_W + sh_dim) + nb
                  + res.tables.numel() + res.density[0].numel()
                  + res.color[0].numel())
    return samples, anchors, flop, nbytes


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


def check_march_ragged(o, d, res, net, common, dev):
    """The march once more, held bit for bit against its plain version, at
    shapes the frame does not give it: RAGGED_B rays a block (not a
    multiple of 32), group RAGGED_GROUP, budgets below the chunk among
    RAGGED_BUDGETS, per-ray exit; at the frame's chunk and at the largest
    (where a CTA holds two warp groups, not three)."""
    import torch
    from repro_torch.core import mlp as mlp_lib
    from repro_torch.kernels import fused_march as FMA

    nb, B = len(RAGGED_BUDGETS), RAGGED_B
    oo, dd = o[:nb * B].contiguous(), d[:nb * B].contiguous()
    sh = mlp_lib.sh_encode(dd, net.sh_degree).contiguous()
    budgets = torch.tensor(RAGGED_BUDGETS, dtype=torch.int32, device=dev)
    wd, dims_d = res.density
    wc, dims_c = res.color
    args = (oo, dd, sh, budgets, res.meta, res.tables, wd, dims_d, wc, dims_c)
    for chunk in (common["chunk"], FMA.MAX_CHUNK):
        kw = dict(common, block_size=B, chunk=chunk, group=RAGGED_GROUP,
                  with_color=True, per_ray_exit=True)
        out = FMA.fused_march(*args, **kw)
        err, _ = max_err(out, FMA.fused_march_plain(*args, **kw))
        groups = FMA.warp_groups(dims_d, dims_c, sh.shape[1], chunk,
                                 res.tables.shape[0])
        print(f"[kernel] fused_march on {nb} blocks of {B} rays, group "
              f"{RAGGED_GROUP}, chunk {chunk} ({groups} warp groups a CTA), "
              f"budgets {list(RAGGED_BUDGETS)}, per-ray exit: "
              f"max_abs_err={err:.3e}; block chunks "
              f"{out.reshape(nb, B, 8)[:, 0, 5].int().tolist()}", flush=True)
        if err != 0.0:
            raise AssertionError("fused_march differs from its plain version "
                                 f"at the ragged shape, chunk {chunk}")


def check_smem(bundle, attn):
    """The shared memory the density, march and volume-render launchers
    ask for at ``bundle``'s widths (the decoupled frame's, and the ragged
    renders') equals the wrappers' reckoning (which the first two check
    against SMEM_LIMIT before a launch); the flash-attention launcher's
    tiles, shared memory and grid at ``attn``'s widths, and the key tiles
    its kernels load for each query tile, are the wrapper's."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_march as FMA
    from repro_torch.kernels import fused_mlp as FM
    from repro_torch.kernels import volume_render as VR

    net, acfg = bundle.model.net, bundle.asdr
    dims_d, dims_c = tuple(net.density_sizes()), tuple(net.color_sizes())
    L = bundle.model.grid.n_levels
    pairs = [("density_mlp", FM.density_launch_smem(dims_d),
              FM.density_smem_bytes(dims_d))]
    for S, chunk in ((net.sh_dim, acfg.chunk), (0, acfg.chunk),
                     (net.sh_dim, FMA.MAX_CHUNK)):
        pairs.append((f"fused_march S={S} chunk {chunk}",
                      FMA.launch_smem(dims_d, dims_c, S, chunk, L),
                      FMA.smem_bytes(dims_d, dims_c, S, chunk, L)))
    ns, gr = bundle.asdr.ns_full, bundle.asdr.group
    for S, A, g in ((ns, -(-ns // gr), gr),) + tuple(
            r[1:] for r in RAGGED_RENDERS):
        pairs.append((f"volume_render S={S} A={A} group {g}",
                      VR.volume_render_launch_smem(S, A, g),
                      VR.volume_render_smem_bytes(S, A, g)))
    for dt in (torch.float32, torch.bfloat16):
        for Dh, S in ((attn.head_dim, ATTN_SEQ), (64, RAGGED_SEQ)):
            got = FA.launch_config(Dh, 1, S, attn.n_heads, dt)
            want = (FA.QUERY_TILE[dt], FA.KEY_TILE[dt], FA.smem_bytes(Dh, dt),
                    *FA.grid(1, S, attn.n_heads, dt))
            print(f"[build] flash_attention {dt} head_dim {Dh} S {S}: the "
                  f"launcher's (query rows, keys, shared memory, grid) "
                  f"{got}, the wrapper's {want}", flush=True)
            if got != want or got[2] > FM.SMEM_LIMIT:
                raise AssertionError(f"flash_attention {dt}: launch "
                                     f"configuration {got}, reckoned {want}")
        for S, w in ((ATTN_SEQ, 0), (ATTN_SEQ, attn.window), (RAGGED_SEQ, 0),
                     (RAGGED_SEQ, RAGGED_WINDOW)):
            bad = [q0 for q0 in range(0, S, FA.QUERY_TILE[dt])
                   if FA.launched_key_tiles(q0, S, w, dt)
                   != FA.key_tiles(q0, S, w, dt)]
            print(f"[build] flash_attention {dt} S {S} window {w}: the "
                  f"kernel's key tiles differ from the wrapper's at "
                  f"{len(bad)} of {-(-S // FA.QUERY_TILE[dt])} query tiles",
                  flush=True)
            if bad:
                raise AssertionError(f"flash_attention {dt}: the kernel loads "
                                     f"other key tiles at query tiles {bad}")
    for name, got, want in pairs:
        print(f"[build] {name}: the launcher asks for {got} B of shared "
              f"memory, the wrapper reckons {want} B (limit "
              f"{FM.SMEM_LIMIT} B)", flush=True)
        if got != want or got > FM.SMEM_LIMIT:
            raise AssertionError(f"{name}: shared memory {got} B, reckoned "
                                 f"{want} B")


def check_hash_encode(pts, o, d, meta, tables, acfg, dev):
    """The hash encode bit for bit against its plain version on the Phase-I
    rows ``pts`` and on one decoupled chunk's rows (the first
    DECOUPLED_RAYS_PER_CALL rays of the frame x ns_full), each timed warm
    and cold with the card sampled beside; on the Phase-I rows also the
    sector reckoning of both mappings.  Returns the Phase-I encoding and
    the kernel's row (Phase-I rows, warm)."""
    import torch
    from repro_torch.core import scene
    from repro_torch.kernels import hash_encode as HE

    L, T, F = tables.shape
    step = DECOUPLED_RAYS_PER_CALL
    chunk, _, _ = scene.sample_points(o[:step], d[:step], acfg.ns_full)
    chunk = chunk.reshape(-1, 3).contiguous()
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    enc_phase1 = row = None
    for tag, x in (("Phase-I rows", pts), ("decoupled chunk rows", chunk)):
        n = x.shape[0]

        def kern():
            return HE.hash_encode(x, meta, tables)

        enc = kern()
        enc_p, plain_ms = timed(lambda: HE.hash_encode_plain(x, meta, tables),
                                dev, 1)
        with SmiSampler(dev) as smi:
            smi.wait_for_samples()
            warm = timed_rounds(kern, dev)
            cold = timed_rounds(kern, dev, flush=flush)
        print(f"[kernel] hash_encode on the {tag} ({n} points x {L} levels): "
              f"warm {spread(warm)} ms, cold (after a {FLUSH_BYTES >> 20} MiB "
              f"flush) {spread(cold)} ms; {smi.summary()}", flush=True)
        args = (enc, enc_p, sorted(warm)[len(warm) // 2], plain_ms)
        kw = dict(flop=n * L * ENCODE_FLOP,
                  nbytes=4 * (n * 3 + n * L * F + tables.numel()
                              + meta.numel()), exact=True)
        del enc_p
        if row is not None:
            check(f"hash_encode on the {tag}", *args, **kw)
            continue
        row = kernel_row("hash_encode", "hash_encode.cu",
                         "src/repro/kernels/hash_encode.py:94", *args, **kw)
        enc_phase1 = enc
        # the bound counts each table byte once; the gathers touch these
        # distinct sectors, each warp's counted once
        for mapping, name in (("level", "level groups (this kernel)"),
                              ("point", "point-major (the kernel it replaced)")):
            sec = HE.warp_sectors(x, meta, F, mapping)
            tot = int(sec.sum())
            print(f"[kernel] hash_encode on the {tag}, {name}: its warps' "
                  f"gathers touch {tot} distinct 32-B sectors ({tot / n:.2f} "
                  f"a point; by level "
                  f"{[round(v / n, 2) for v in sec.tolist()]}), "
                  f"{1e3 * 32 * tot / PEAK_BYTES:.3f} ms at the memory rate "
                  f"were none in L2", flush=True)
    del flush, chunk
    return enc_phase1, row


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

    # ---- hash encode on the Phase-I samples, then a decoupled chunk's
    enc, he_row = check_hash_encode(pts, o, d, meta, tables, acfg, dev)
    rows.append(he_row)

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
        library_ms=lib_ms, exact=True)
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
    rgb_p, plain_ms = timed(lambda: in_chunks(
        FM.color_mlp_plain, cin, rest=(wc, dims_c)), dev, 1)
    _, lib_ms = timed(color_matmul, dev, reps)
    row("color_mlp", "fused_mlp.cu", "src/repro/kernels/fused_mlp.py:145",
        rgb, rgb_p, ms, plain_ms, flop=n * fl_d["color_flops"],
        nbytes=4 * (cin.numel() + rgb.numel() + wc.numel()),
        library_ms=lib_ms, exact=True)
    del rgb_p
    # a ragged tile and an input that is not 16-B aligned (the wrapper
    # copies it): rows 3 .. 3 + 64k + 37
    tail = cin[3:3 + 64 * 1601 + 37]
    err_t, _ = max_err(FM.color_mlp(tail, wc, dims_c),
                       FM.color_mlp_plain(tail, wc, dims_c))
    print(f"[kernel] color_mlp on {tail.shape[0]} rows from row 3: "
          f"max_abs_err={err_t:.3e}", flush=True)
    if err_t != 0.0:
        raise AssertionError("color_mlp differs from its plain version on a "
                             "ragged, unaligned input")
    del cin, tail

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
    ff_p, plain_ms = timed(lambda: in_chunks(
        FM.fused_field_plain, enc, sh, rest=(wd, dims_d, wc, dims_c)), dev, 1)
    _, lib_ms = timed(fused_matmul, dev, reps)
    row("fused_field", "fused_mlp.cu", "src/repro/kernels/fused_mlp.py:116",
        ff, ff_p, ms, plain_ms,
        flop=n * (fl_d["density_flops"] + fl_d["color_flops"]),
        nbytes=4 * (enc.numel() + sh.numel() + ff.numel() + wd.numel()
                    + wc.numel()),
        library_ms=lib_ms, exact=True)
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
        # every variant against the plain version on all the frame's blocks
        def kern():
            return FMA.fused_march(*args, shv, budgets, meta, tables, wd,
                                   dims_d, wc, dims_c, **common, **kw)

        def plain():
            return FMA.fused_march_plain(*args, shv, budgets, meta, tables,
                                         wd, dims_d, wc, dims_c, **common,
                                         **kw)

        out, ms = timed(kern, dev, reps)
        out_p, plain_ms = timed(plain, dev, 1)
        exact_c = torch.equal(out[:, 5:7], out_p[:, 5:7])
        print(f"[kernel] fused_march{tag}: counters exact={exact_c} (plain on "
              f"all {nb} blocks); block chunks "
              f"{out.reshape(nb, B, 8)[:, 0, 5].int().tolist()}", flush=True)
        if not exact_c:
            raise AssertionError(f"fused_march{tag}: chunk counters differ "
                                 "from the plain version")
        # work this run's data needs: valid samples of the chunks each
        # block ran (per live ray with per-ray exit), color on their anchors
        counters = out.reshape(nb, B, 8).cpu().numpy()
        runs = counters[:, :, 6 if kw["per_ray_exit"] else 5]
        samples, anchors, flop, nbytes = march_reckoning(
            runs, bud, res, acfg, fl_d, kw["with_color"])
        work = f"{samples} samples" + (f", {anchors} anchors with color"
                                       if kw["with_color"] else "")
        print(f"[kernel] fused_march{tag}: {work}", flush=True)
        if tag:
            check(f"fused_march{tag}", out, out_p, ms, plain_ms, flop, nbytes,
                  exact=True)
        else:
            row("fused_march", "fused_march.cu",
                "src/repro/kernels/fused_march.py:329", out, out_p, ms,
                plain_ms, flop, nbytes, exact=True)
        del out, out_p
    check_march_ragged(o, d, res, net, common, dev)
    return rows, ff_launches


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev):
    """(result, ms): host clock around one call that ends in a
    synchronize."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, 1e3 * (time.perf_counter() - t0)


def render_frame(fns, acfg, cam, dev):
    """(image, stats, ms) of one render_asdr_image call, host clock around
    work that ends in a synchronize."""
    from repro_torch.core import pipeline

    (img, st), ms = host_ms(
        lambda: pipeline.render_asdr_image(fns, acfg, cam, device=dev), dev)
    return img, st, ms


def frame_blocks(fns, acfg, cam, dev):
    """The blocks render_asdr_image marches in Phase II: Phase I's counts,
    padded and sorted into blocks by budget.  Returns (o, d, budgets)."""
    from repro_torch.core import pipeline, scene
    o, d = scene.camera_rays(cam, device=dev)
    probe = pipeline.probe_phase(fns, acfg, cam,
                                 return_opacity=acfg.sort_by_opacity,
                                 device=dev)
    opacity = probe[2] if acfg.sort_by_opacity else None
    o, d, counts, opacity, _ = pipeline.pad_rays_to_blocks(acfg, o, d,
                                                           probe[0], opacity)
    order, budgets = pipeline.block_sort(acfg, counts, opacity)
    B = acfg.block_size
    return o[order].reshape(-1, B, 3), d[order].reshape(-1, B, 3), budgets


def time_frame_march(fns, acfg, cam, stats, dev, reps=3):
    """The fused march alone on the frame's own blocks and budgets, with
    and without color, each beside the bound of the work its chunk
    counters say it needed; its chunk counts must be the frame's."""
    import torch
    from repro_torch.core import mlp as mlp_lib
    from repro_torch.kernels import ops

    o_s, d_s, budgets = frame_blocks(fns, acfg, cam, dev)
    fl_d = mlp_lib.flops_per_sample(fns.fused.net)

    def march(density_only):
        return ops.fused_march_blocks(fns.fused, acfg, o_s, d_s, budgets,
                                      density_only=density_only)

    out, ms = timed(lambda: march(False), dev, reps)
    out_d, ms_density = timed(lambda: march(True), dev, reps)
    same = (torch.equal(budgets, stats["budgets"])
            and torch.equal(out[3], stats["chunks_per_block"]))
    print(f"[frame] fused march alone on the frame's {budgets.shape[0]} "
          f"blocks (budgets from Phase I): {ms:.3f} ms, density only "
          f"{ms_density:.3f} ms; budgets and chunks as in the frame: {same}",
          flush=True)
    for tag, o_m, t_ms, color in (("with color", out, ms, True),
                                  ("density only", out_d, ms_density, False)):
        runs = (o_m[4] if acfg.per_ray_early_exit
                else o_m[3][:, None].expand(o_m[4].shape))
        samples, anchors, flop, nbytes = march_reckoning(
            runs.cpu().numpy(), budgets.cpu().numpy(), fns.fused, acfg, fl_d,
            color)
        b_ms, b_by = bound(flop, nbytes)
        print(f"[frame] fused march alone, {tag}: {samples} samples "
              f"(those within the budgets; the frame counts whole chunks, "
              f"{stats['samples_processed']})"
              f"{f', {anchors} anchors with color' if color else ''}; "
              f"{t_ms:.3f} ms against a bound of {b_ms:.3f} ms ({b_by}, "
              f"{100 * b_ms / t_ms:.0f} % of it)", flush=True)
    if not same:
        raise AssertionError("the frame's march, run alone, ran other chunks")


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
    _, ms_probe = host_ms(
        lambda: pipeline.probe_phase(fns_k, fused, cam, device=dev), dev)
    img_r, st_r, ms_r = render_frame(fns_k, reference, cam, dev)
    img_p, st_p, ms_p = render_frame(fns_p, reference, cam, dev)
    print(f"[frame] kernel path, fused march (second run): {ms_k2:.1f} ms, "
          f"of which Phase I alone {ms_probe:.1f} ms; kernel field, "
          f"reference march: {ms_r:.1f} ms; plain field, reference march: "
          f"{ms_p:.1f} ms", flush=True)
    time_frame_march(fns_k, fused, cam, st_k, dev)

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


def stream_overlap(prof, kernel):
    """How the launches of ``kernel`` shared the card with work on other
    streams, from the profiler's device events: (its launches, their ms,
    the other streams' events, their ms, the ms of those events inside a
    launch of ``kernel``, how many of them overlap one)."""
    import numpy as np
    from torch.autograd import DeviceType

    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() != DeviceType.CPU]
    mine = [e for e in evs if kernel in e.name()]
    streams = {e.device_resource_id() for e in mine}
    other = [e for e in evs if e.device_resource_id() not in streams]
    start = np.array([e.start_ns() for e in other], np.float64)
    end = start + np.array([e.duration_ns() for e in other], np.float64)
    inside, n = 0.0, 0
    for e in mine:
        ov = np.clip(np.minimum(end, e.start_ns() + e.duration_ns())
                     - np.maximum(start, e.start_ns()), 0.0, None)
        inside += float(ov.sum())
        n += int((ov > 0).sum())
    return (len(mine), sum(e.duration_ns() for e in mine) / 1e6, len(other),
            float((end - start).sum()) / 1e6, inside / 1e6, n)


def report_device_time(what, fn, dev, top=6, share_of="hash_encode_kernel",
                       overlap_of=None):
    """One more call of ``fn`` under torch.profiler: its device time by
    kernel, the share of the kernels named ``share_of``, the kernels
    launched and the device's idle share of the call's wall time ("not
    measured" where the profiler sees no device time); with
    ``overlap_of``, how that kernel's launches overlapped the device work
    of other streams (``stream_overlap``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = 1e3 * (time.perf_counter() - t0)
    by_name = {}           # the kernels' own events, not the host ops'
    n_kernels = 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CPU and evt.self_device_time_total:
            by_name[evt.key] = evt.self_device_time_total / 1e3
            n_kernels += evt.count
    busy = sum(by_name.values())
    if busy == 0:
        print(f"{what} under torch.profiler ({wall:.1f} ms): device time not "
              f"measured (the profiler recorded none)", flush=True)
        return
    part = sum(v for k, v in by_name.items() if share_of in k)
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    print(f"{what} under torch.profiler: {wall:.1f} ms wall, {busy:.1f} ms on "
          f"the device (idle share {1 - busy / wall:.3f}), {n_kernels} "
          f"kernels; {share_of} {part:.1f} ms ({part / busy:.3f} of device "
          f"time); heaviest {[(k[:60], round(v, 3)) for k, v in heavy]}",
          flush=True)
    if overlap_of is not None:
        n, ms, n_o, ms_o, inside, n_in = stream_overlap(prof, overlap_of)
        print(f"{what}: {n} {overlap_of} launches, {ms:.1f} ms on the "
              f"device; {n_o} device events on other streams, {ms_o:.1f} "
              f"ms, of which {inside:.1f} ms ({n_in} events) ran inside a "
              f"{overlap_of} launch", flush=True)


def ground_truth(scene_field, cam, dev):
    """The analytic scene's 512-sample render of ``cam``, in ray chunks."""
    import torch
    from repro_torch.core import scene
    o, d = scene.camera_rays(cam, device=dev)
    step = GT_RAYS_PER_CALL
    rgb = torch.cat([scene.render_reference(scene_field, o[s:s + step],
                                            d[s:s + step])[0]
                     for s in range(0, o.shape[0], step)])
    return rgb.reshape(cam.height, cam.width, 3)


def profile_train_steps(cfg, model_cfg, field, scene_field, dev):
    """``TRAIN_PROFILE_STEPS`` more steps from the trained weights, on one
    batch drawn from the training views' rays (its duplicate corners set
    the gather backward's time), under torch.profiler: the step's device
    time by kernel, kernels launched and idle share."""
    import torch
    from repro_torch import optim
    from repro_torch.core import train

    o, d, ref = train._make_view_rays(cfg, scene_field, dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    idx = torch.randint(0, o.shape[0], (cfg.batch_rays,), generator=gen,
                        device=dev)
    jitter = torch.rand((cfg.batch_rays, cfg.n_samples), generator=gen,
                        device=dev)
    opt = optim.AdamWConfig(lr=cfg.lr, b2=0.99, eps=1e-15)
    step = train.make_train_step(cfg, model_cfg, opt)
    state = {"params": field.params()}
    state["opt"] = optim.adamw_init(state["params"], opt)

    def steps():
        for _ in range(TRAIN_PROFILE_STEPS):
            state["params"], state["opt"], _ = step(
                state["params"], state["opt"], o[idx], d[idx], ref[idx],
                jitter, cfg.lr)

    report_device_time(f"[train] {TRAIN_PROFILE_STEPS} steps", steps, dev,
                       share_of="indexing_backward")


def error_by_count(counts, img, fixed, gt) -> dict:
    """{count: (share of pixels, share of the frame's squared error against
    ground truth, share of its excess over fixed-192's)} of a frame."""
    import torch
    err = ((img - gt) ** 2).sum(-1).reshape(-1)
    excess = err - ((fixed - gt) ** 2).sum(-1).reshape(-1)
    out = {}
    for c in torch.unique(counts).tolist():
        m = counts == c
        out[c] = tuple(round(float(x), 4) for x in (
            m.float().mean(), err[m].sum() / err.sum(),
            excess[m].sum() / excess.sum()))
    return out


def run_train(bundle, cam, dev, train_kw=TRAIN):
    """Train the bundle's NGP on the card, then render the trained scene at
    ``cam``: fixed-``ns_full`` and the two-phase frame through the kernel
    field (built from the trained field: it packs the MLP weights when
    built), held against the plain field's two-phase frame; the trained
    frames' launches must show every kernel of FRAME_KERNELS."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import model, rendering, train
    from repro_torch.kernels import ops

    cfg = train.NGPTrainConfig(**train_kw)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    (field, _, scene_field, hist), wall = host_ms(
        lambda: train.train_ngp(cfg, bundle.model, device=dev, verbose=False),
        dev)
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else float("nan"))
    step_ms = 1e3 * np.diff([0.0] + [h[2] for h in hist])
    first, last = hist[0][1], hist[-1][1]
    print(f"[train] {cfg.steps} steps of {cfg.batch_rays} rays x "
          f"{cfg.n_samples} samples on {cfg.n_views} views of "
          f"{cfg.view_hw[0]}x{cfg.view_hw[1]} ({cfg.scene}): "
          f"{np.median(step_ms[TRAIN_WARM_STEPS:]):.2f} ms a step (median "
          f"after the first {TRAIN_WARM_STEPS}; first step "
          f"{step_ms[0]:.1f} ms), {hist[-1][2]:.1f} s of steps, "
          f"{wall / 1e3:.1f} s with the views; loss {first:.5f} -> "
          f"{last:.5f} ({last / first:.3f}x); peak memory {peak:.2f} GiB",
          flush=True)
    finite = all(bool(torch.isfinite(b).all()) for b in field.buffers())
    if not (last < TRAIN_LOSS_GATE * first and finite):
        raise AssertionError(f"training: loss {first} -> {last} (gate "
                             f"{TRAIN_LOSS_GATE}x), finite weights {finite}")
    profile_train_steps(cfg, bundle.model, field, scene_field, dev)

    acfg = dataclasses.replace(bundle.asdr, march_backend="fused")
    ns, H, W = acfg.ns_full, cam.height, cam.width
    gt = ground_truth(scene_field, cam, dev)
    fns_k = ops.field_fns(field)
    fns_p = model.field_fns(field)

    def frames():
        return (fixed_reference(fns_k, cam, ns, dev),
                render_frame(fns_k, acfg, cam, dev))

    (fixed, (img_k, st_k, ms_k1)), launches = path_launches(FRAME_KERNELS,
                                                            frames)
    _, ms_fixed = host_ms(lambda: fixed_reference(fns_k, cam, ns, dev), dev)
    _, _, ms_k = render_frame(fns_k, acfg, cam, dev)
    img_p, st_p, ms_p = render_frame(fns_p, acfg, cam, dev)
    p_fixed = float(rendering.psnr(fixed, gt))
    p_k = float(rendering.psnr(img_k, gt))
    p_p = float(rendering.psnr(img_p, gt))
    p_kf = float(rendering.psnr(img_k, fixed))
    print(f"[train] trained frame {H}x{W}: fixed-{ns} through the kernel "
          f"field (chunks of 32,768 rays) {ms_fixed:.1f} ms, PSNR "
          f"{p_fixed:.4f} dB vs ground truth (512 samples); ASDR (kernel "
          f"field, fused march) {ms_k:.1f} ms (first run {ms_k1:.1f}), PSNR "
          f"{p_k:.4f} dB vs ground truth, {p_kf:.4f} dB vs fixed-{ns}; "
          f"gap to fixed-{ns} {p_fixed - p_k:.4f} dB (the paper: ~0.1); "
          f"launches {launches}", flush=True)
    vals, nums = torch.unique(st_k["counts"], return_counts=True)
    budgets = st_k["budgets"].cpu().numpy()
    bv, bn = np.unique(budgets, return_counts=True)
    chunks = st_k["chunks_per_block"].cpu().numpy()
    early = int((chunks < -(-budgets // acfg.chunk)).sum())
    spent = st_k["samples_processed"] + st_k["probe_samples"]
    base = H * W * ns
    print(f"[train] count histogram {dict(zip(vals.tolist(), nums.tolist()))}"
          f"; budgets {bv.tolist()} x {bn.tolist()}; {early} of "
          f"{len(chunks)} blocks exit early; samples {st_k['samples_processed']}"
          f" + probe {st_k['probe_samples']} = {spent} of {H * W} x {ns} = "
          f"{base} ({spent / base:.4f}); fixed-{ns} / ASDR frame time "
          f"{ms_fixed / ms_k:.3f}x (the paper's software-only GPU figure, "
          f"Fig. 24 AS: {PAPER_AS_SPEEDUP}x)", flush=True)
    print(f"[train] by count: {error_by_count(st_k['counts'], img_k, fixed, gt)}",
          flush=True)
    diff = float((st_k["counts"] != st_p["counts"]).float().mean())
    print(f"[train] plain field, same frame: {ms_p:.1f} ms, PSNR {p_p:.4f} "
          f"dB vs ground truth; count-map share differing from the kernel "
          f"path {diff:.3e}; PSNR gap {p_k - p_p:.4f} dB", flush=True)
    if not (all(math.isfinite(x) for x in (p_fixed, p_k, p_p, p_kf))
            and bool(torch.isfinite(img_k).all())
            and bool(torch.isfinite(fixed).all())
            and tuple(img_k.shape) == tuple(fixed.shape) == (H, W, 3)):
        raise AssertionError("non-finite or misshapen trained frame")
    if diff > MAX_COUNT_DIFF:
        raise AssertionError(f"trained count maps differ in {diff:.3e} of "
                             f"pixels (limit {MAX_COUNT_DIFF})")
    if abs(p_k - p_p) > MAX_PSNR_DIFF:
        raise AssertionError(f"trained PSNR gap {p_k - p_p:.4f} dB (limit "
                             f"{MAX_PSNR_DIFF})")
    return field, scene_field


def reuse_trajectory(fns, acfg, cams, fc, dev):
    """[(image, stats, ms)] of render_asdr_image_cached over ``cams`` with
    the reuse state ``fc``, host clock around each synchronised call."""
    from repro_torch import framecache

    return [(*out, ms) for out, ms in (
        host_ms(lambda: framecache.render_asdr_image_cached(
            fns, acfg, cam, fc, device=dev), dev) for cam in cams)]


def reuse_cache():
    """All three reuse tiers at their defaults, the scene-space block tier
    a fresh SceneBlockCache at its default budget."""
    from repro_torch import framecache, scenecache
    return framecache.make_frame_cache(
        scene_cache=scenecache.SceneBlockCache(), scene_id="lego")


def same_stats(a, b) -> bool:
    import torch
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else a[k] == b[k] for k in a)


def replay_hits(store, fns, acfg, cams, dev):
    """Gate (d): the trajectory again with radiance reuse off on ``store``,
    every lookup logged as (key resident after the first pass, resident
    just before the lookup, hit).  Returns (frames, log)."""
    from repro_torch import framecache

    first, log, lookup = set(store._entries), [], store.lookup

    def logged(key, count_miss=True):
        before = key in store._entries
        out = lookup(key, count_miss)
        log.append((key in first, before, out is not None))
        return out

    store.lookup = logged
    try:
        frames = reuse_trajectory(fns, acfg, cams, framecache.make_frame_cache(
            radiance_cfg=None, scene_cache=store, scene_id="lego"), dev)
    finally:
        del store.lookup
    return frames, log


def reuse_host_costs(fns, acfg, cam, cfg, dev):
    """The host's share of a frame the block store misses, on the frame's
    own blocks: the sorted rays' copy to the host, their block keys, and
    the march outputs' copy to the host and stores (ms each)."""
    from repro_torch.kernels import ops
    from repro_torch.scenecache import SceneBlockCache, block_keys

    o_s, d_s, budgets = frame_blocks(fns, acfg, cam, dev)
    host, ms_copy = host_ms(lambda: [t.cpu().numpy()
                                     for t in (o_s, d_s, budgets)], dev)
    keys, ms_keys = host_ms(lambda: block_keys(cfg, "lego", acfg, *host), dev)
    out = ops.fused_march_blocks(fns.fused, acfg, o_s, d_s, budgets)
    store = SceneBlockCache(cfg)

    def stores():
        rgb, acc, dep, ch = (t.cpu().numpy() for t in out[:4])
        for j, (k, cell) in enumerate(keys):
            store.store(k, cell, rgb[j], acc[j], dep[j], int(ch[j]))

    _, ms_store = host_ms(stores, dev)
    print(f"[reuse] host work of a missed frame ({len(keys)} blocks): rays "
          f"to the host {ms_copy:.1f} ms, block keys {ms_keys:.1f} ms, "
          f"outputs to the host and stores {ms_store:.1f} ms", flush=True)


def run_reuse(field, scene_field, bundle, dev, hw, poses=TRAJ_POSES):
    """The cross-frame reuse path on the trained field: the trajectory
    through the kernel field (fused march) with all tiers, each frame
    against a fresh render_asdr_image of its pose and the analytic ground
    truth, then gates (a)-(d).  Returns the trajectory's launches."""
    import dataclasses
    import json
    import torch
    from repro_torch import obs
    from repro_torch.core import model, rendering, scene
    from repro_torch.kernels import ops
    sys.path.insert(0, str(ROOT / "tools"))
    import check_trace

    t0 = time.perf_counter()
    acfg = dataclasses.replace(bundle.asdr, march_backend="fused")
    cams = [scene.look_at_camera(hw[0], hw[1], theta=CAMERA["theta"]
                                 + TRAJ_STEP * k, phi=CAMERA["phi"])
            for k in range(poses)]
    fns_k, fns_p = ops.field_fns(field), model.field_fns(field)
    fc = reuse_cache()
    traj, launches = path_launches(FRAME_KERNELS, lambda: reuse_trajectory(
        fns_k, acfg, cams, fc, dev))
    fresh = [render_frame(fns_k, acfg, cam, dev) for cam in cams]
    gts = [ground_truth(scene_field, cam, dev) for cam in cams]
    print(f"[reuse] {poses} poses of {hw[0]}x{hw[1]} at theta "
          f"{CAMERA['theta']} + {TRAJ_STEP} k, phi {CAMERA['phi']}, kernel "
          f"field, fused march, all tiers (SceneBlockCache budget "
          f"{fc.scene.cfg.byte_budget >> 20} MiB); launches {launches}",
          flush=True)
    for k, ((img, st, ms), (f_img, _, f_ms), gt) in enumerate(
            zip(traj, fresh, gts)):
        print(f"[reuse] frame {k}: {ms:.1f} ms (fresh {f_ms:.1f}); rays "
              f"marched {st['rays_marched']} of {st['rays_total']}; "
              f"{', '.join(f'{f} {st[f]}' for f in REUSE_FLAGS)}; warp valid "
              f"{st['warp_valid_fraction']:.4f}; scene blocks "
              f"{st['scene_block_hits']} hit / {st['scene_block_misses']} "
              f"missed; samples processed {st['samples_processed']}, reused "
              f"{st['samples_reused']}, probe {st['probe_samples']}; PSNR vs "
              f"fresh {float(rendering.psnr(img, f_img)):.4f} dB, vs ground "
              f"truth {float(rendering.psnr(img, gt)):.4f} dB (fresh "
              f"{float(rendering.psnr(f_img, gt)):.4f})", flush=True)
    total, total_f = sum(t[2] for t in traj), sum(f[2] for f in fresh)
    print(f"[reuse] trajectory {total:.1f} ms against {total_f:.1f} ms "
          f"rendered fresh ({total_f / total:.3f}x); rays marched "
          f"{sum(t[1]['rays_marched'] for t in traj)} of "
          f"{sum(t[1]['rays_total'] for t in traj)}; scene cache "
          f"{fc.scene.stats()}", flush=True)
    reuse_host_costs(fns_k, acfg, cams[0], fc.scene.cfg, dev)
    if not all(bool(torch.isfinite(t[0]).all())
               and tuple(t[0].shape) == (hw[0], hw[1], 3) for t in traj):
        raise AssertionError("[reuse]: non-finite or misshapen frame")
    a_ok = (torch.equal(traj[0][0], fresh[0][0])
            and torch.equal(traj[0][1]["counts"], fresh[0][1]["counts"]))
    print(f"[reuse] gate (a): frame 0, all tiers cold, bit-equal to "
          f"render_asdr_image (image and count map): {a_ok}", flush=True)
    if not a_ok:
        raise AssertionError("[reuse] gate (a): the cold frame differs from "
                             "render_asdr_image")

    # (b) the plain field's trajectory against the kernel field's
    plain = reuse_trajectory(fns_p, acfg, cams, reuse_cache(), dev)
    worst = [0.0, 0.0, 0.0]
    flags_eq = True
    for (img, st, _), (img_p, st_p, _), gt in zip(traj, plain, gts):
        flags_eq &= all(st[f] == st_p[f] for f in REUSE_FLAGS)
        worst[0] = max(worst[0], abs(st["rays_marched"] - st_p["rays_marched"])
                       / st["rays_total"])
        if st["counts"] is not None and st_p["counts"] is not None:
            worst[1] = max(worst[1], float(
                (st["counts"] != st_p["counts"]).float().mean()))
        worst[2] = max(worst[2], abs(float(rendering.psnr(img, gt))
                                     - float(rendering.psnr(img_p, gt))))
    print(f"[reuse] gate (b): plain field, same trajectory "
          f"({sum(t[2] for t in plain):.1f} ms): flags equal {flags_eq}; "
          f"worst rays-marched gap {worst[0]:.3e} of the rays, count-map "
          f"share {worst[1]:.3e}, PSNR gap vs ground truth {worst[2]:.4f} "
          f"dB", flush=True)
    if not (flags_eq and worst[0] <= MAX_COUNT_DIFF
            and worst[1] <= MAX_COUNT_DIFF and worst[2] <= MAX_PSNR_DIFF):
        raise AssertionError("[reuse] gate (b): the plain field's trajectory "
                             "differs from the kernel field's")
    del plain

    # (c) the same trajectory with a tracer installed
    tracer = obs.Tracer(obs.TraceConfig())
    obs.install(tracer)
    try:
        traced = reuse_trajectory(fns_k, acfg, cams, reuse_cache(), dev)
    finally:
        obs.uninstall(tracer)
    tracer.drain()
    c_ok = all(torch.equal(a[0], b[0]) and same_stats(a[1], b[1])
               for a, b in zip(traj, traced))
    by_name = {}
    for sp in tracer.spans:
        n, ms = by_name.get(sp.name, (0, 0.0))
        by_name[sp.name] = (n + 1, ms + sp.dur_ms)
    export = json.loads(json.dumps(obs.export.chrome_trace(
        tracer.spans, tracer.export_origin(), tracer.dropped), default=str))
    bad = check_trace.validate(export)
    missing = [n for n in REUSE_SPANS if n not in by_name]
    print(f"[reuse] gate (c): traced trajectory bit-identical (frames and "
          f"stats) {c_ok} ({sum(t[2] for t in traced):.1f} ms); spans "
          f"{ {n: (c, round(ms, 1)) for n, (c, ms) in by_name.items()} }; "
          f"{len(export['traceEvents'])} events exported, "
          f"{len(bad)} schema findings; missing spans {missing}", flush=True)
    if not c_ok or bad or missing:
        raise AssertionError(f"[reuse] gate (c): traced run differs "
                             f"({not c_ok}), export {bad[:3]}, missing "
                             f"spans {missing}")
    del traced

    # (d) replay without radiance reuse on the same block store
    replay, log = replay_hits(fc.scene, fns_k, acfg, cams, dev)
    kept = sum(1 for first, before, _ in log if first and before)
    hits = sum(1 for _, _, hit in log if hit)
    whole = [k for k, t in enumerate(traj)
             if t[1]["rays_marched"] == t[1]["rays_total"]]
    back = [k for k in whole if torch.equal(replay[k][0], traj[k][0])
            and torch.equal(replay[k][1]["counts"], traj[k][1]["counts"])]
    d_ok = (all(before == hit for _, before, hit in log) and kept > 0
            and hits == sum(r[1]["scene_block_hits"] for r in replay)
            and back == whole)
    print(f"[reuse] gate (d): replay without radiance reuse "
          f"({sum(r[2] for r in replay):.1f} ms; per frame "
          f"{[round(r[2], 1) for r in replay]} ms, block hits "
          f"{[r[1]['scene_block_hits'] for r in replay]}): {len(log)} "
          f"lookups, {hits} hits, {kept} of them blocks the first pass left "
          f"resident; every resident block hit: "
          f"{all(b == h for _, b, h in log)}; whole-march frames {whole} "
          f"bit-equal: {back}", flush=True)
    if not d_ok:
        raise AssertionError("[reuse] gate (d): the replay missed a resident "
                             "block or changed a frame")
    print(f"[reuse] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# The [serve] phase: the render serving engine over two scenes at the
# paper's widths, both through the kernel field and the fused march: the
# trained lego field of [train] and the random field of phases 2-4.  Three
# viewers, closed loop, enqueued k-major as the launcher interleaves
# scenes: viewers 0 and 1 on lego and viewer 2 on the random field, each
# at [reuse]'s first SERVE_POSES poses.  The engine at the reference's
# defaults (slots 4, blocks of 16 a batch, prefetch 2) with every reuse
# tier at its defaults and a 32 MiB block store.
SERVE_POSES = 8
SERVE_VIEWERS = ("lego", "lego", "random")
SERVE_STORE_BYTES = 32 << 20
SERVE_REPLAY_POSES = 4          # gate (e): two viewers replay these
SERVE_WIDE_BATCH = 64           # one extra reading, blocks of 64 a batch
SERVE_FLAGS = ("probe_reused", "probe_skipped", "radiance_reused")
SERVE_READINGS = (
    "latency_ms_p50", "latency_ms_p99", "admit_stall_ms_p50",
    "admit_stall_ms_p99", "march_ms_p50", "march_ms_p99", "batches",
    "pad_block_fraction", "rays_marched_fraction", "reused_probe_fraction",
    "reused_radiance_fraction", "scene_block_hit_rate", "misprepares",
    "pack_cache_hits", "pack_cache_misses", "pack_cache_size")


def serve_cams(hw, poses=SERVE_POSES):
    from repro_torch.core import scene
    return [scene.look_at_camera(hw[0], hw[1], theta=CAMERA["theta"]
                                 + TRAJ_STEP * k, phi=CAMERA["phi"])
            for k in range(poses)]


def serve_requests(cams, viewers=SERVE_VIEWERS):
    """The k-major traffic: request 3k + v is viewer v at pose k."""
    from repro_torch.serve import RenderRequest
    return [RenderRequest(rid=len(viewers) * k + v, scene=s, cam=cam)
            for k, cam in enumerate(cams) for v, s in enumerate(viewers)]


def serve_config(full=True, **kw):
    """The engine's configuration: the reference's defaults with every
    reuse tier on (``full``), or with every tier off (the identity
    configuration of gate (a))."""
    from repro_torch import framecache, scenecache
    from repro_torch.serve import RenderServeConfig
    tiers = dict(reuse=framecache.ProbeReuseConfig(),
                 radiance=framecache.RadianceReuseConfig(),
                 scenecache=scenecache.SceneCacheConfig(
                     byte_budget=SERVE_STORE_BYTES)) if full else dict(
        reuse=None, radiance=None, scenecache=None, prefetch=0)
    return RenderServeConfig(**{**tiers, **kw})


def timed_calls(module, name, log):
    """Replace ``module.name`` by a wrapper that appends each call's host
    seconds to ``log``; returns the function that restores it."""
    real = getattr(module, name)

    def wrapper(*args, **kw):
        t = time.perf_counter()
        out = real(*args, **kw)
        log.append(time.perf_counter() - t)
        return out

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, real)


def serve_run(fields, acfg, rcfg, reqs, dev, trace=False):
    """One engine over ``fields`` serving ``reqs`` closed loop, host clock
    around the synchronised call.  Returns ({rid: request}, engine_stats,
    wall ms, the tracer's (spans, export origin) or None)."""
    import dataclasses
    from repro_torch import obs
    from repro_torch.serve import RenderServingEngine

    if trace:
        rcfg = dataclasses.replace(rcfg, trace=obs.TraceConfig())
    eng = RenderServingEngine(fields, acfg, rcfg, device=dev)
    try:
        done, ms = host_ms(lambda: eng.render(reqs), dev)
        spans = None
        if eng.tracer is not None:
            eng.tracer.drain()
            spans = (list(eng.tracer.spans), eng.tracer.export_origin())
        return {r.rid: r for r in done}, eng.engine_stats(), ms, spans
    finally:
        eng.close()


def serve_reading(tag, done, st, ms):
    sc = st.get("scenecache") or {}
    print(f"[serve] {tag}: {len(done)} frames in {ms:.1f} ms "
          f"({1e3 * len(done) / ms:.2f} frames/s); "
          + "; ".join(f"{k} {st[k]:.4g}" if isinstance(st[k], float)
                      else f"{k} {st[k]}" for k in SERVE_READINGS)
          + f"; blocks marched {st['blocks_marched']}, scene block hits "
          f"{st['scene_block_hits']}; store resident "
          f"{sc.get('resident_bytes', 0)} B, evictions "
          f"{sc.get('evictions', 0)}; batches a round "
          f"{st['batches_per_round']}", flush=True)


def same_serving(a, b, st_a, st_b) -> bool:
    """Frames bit for bit and the deterministic counters equal."""
    import numpy as np
    from repro_torch.serve.stats import DETERMINISTIC_COUNTERS
    return (a.keys() == b.keys()
            and all(np.array_equal(a[r].image, b[r].image) for r in a)
            and all(st_a[c] == st_b[c] for c in DETERMINISTIC_COUNTERS))


def run_serve(field_t, scene_t, field_r, bundle, dev, hw):
    """The render serving engine through the kernel path: the traffic's
    readings, the same requests one by one through render_asdr_image, then
    gates (a)-(e).  Returns the serve run's launches."""
    import dataclasses
    import json
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core import model, pipeline, rendering
    from repro_torch.serve.stats import DETERMINISTIC_COUNTERS
    from repro_torch.kernels import ops
    from repro_torch.scenecache import key as scenecache_key
    sys.path.insert(0, str(ROOT / "tools"))
    import check_trace

    t0 = time.perf_counter()
    acfg = dataclasses.replace(bundle.asdr, march_backend="fused")
    fields = {"lego": ops.field_fns(field_t), "random": ops.field_fns(field_r)}
    cams = serve_cams(hw)
    B, R = acfg.block_size, hw[0] * hw[1]
    full = serve_config()

    # the main path: the full configuration at the reference's defaults,
    # the host's block keys timed (they run on the engine thread)
    key_s = []
    restore = timed_calls(scenecache_key, "block_keys", key_s)
    try:
        (done, st, ms, _), launches = path_launches(
            FRAME_KERNELS, lambda: serve_run(fields, acfg, full,
                                             serve_requests(cams), dev))
    finally:
        restore()
    print(f"[serve] {len(SERVE_VIEWERS)} viewers {SERVE_VIEWERS} x "
          f"{SERVE_POSES} poses of {hw[0]}x{hw[1]} (theta {CAMERA['theta']} "
          f"+ {TRAJ_STEP} k, phi {CAMERA['phi']}), k-major, kernel field, "
          f"fused march; slots {full.slots}, blocks of {full.blocks_per_batch}"
          f" a batch ({full.blocks_per_batch * B} rays), prefetch "
          f"{full.prefetch}; all tiers, store {SERVE_STORE_BYTES >> 20} MiB; "
          f"launches {launches}", flush=True)
    serve_reading("full, prefetch 2", done, st, ms)
    print(f"[serve] host block keys: {1e3 * sum(key_s):.1f} ms in "
          f"{len(key_s)} calls ({sum(key_s) / ms * 1e3:.3f} of the wall)",
          flush=True)
    for rid, r in sorted(done.items()):
        s = r.stats
        print(f"[serve] request {rid} ({r.scene}, pose {rid // 3}): latency "
              f"{1e3 * r.latency_s:.1f} ms, stall "
              f"{1e3 * s['admit_stall_s']:.1f} ms; rays marched "
              f"{s['rays_marched']}; "
              f"{', '.join(f'{f} {s[f]}' for f in SERVE_FLAGS)}; block hits "
              f"{s['scene_block_hits']}; samples {s['samples_processed']} + "
              f"probe {s['probe_samples']}, reused {s['samples_reused']}",
              flush=True)
    if not all(np.isfinite(r.image).all() and r.image.shape == (*hw, 3)
               for r in done.values()):
        raise AssertionError("[serve]: non-finite or misshapen frame")

    # the same requests one by one through render_asdr_image
    reqs = serve_requests(cams)
    single, ms_single = {}, 0.0
    for r in reqs:
        (img, st1), ms1 = host_ms(lambda: pipeline.render_asdr_image(
            fields[r.scene], acfg, r.cam, device=dev), dev)
        single[r.rid] = (img.cpu().numpy(), st1["samples_processed"],
                         st1["probe_samples"])
        ms_single += ms1
    print(f"[serve] the same {len(reqs)} requests one by one through "
          f"render_asdr_image: {ms_single:.1f} ms ({ms_single / ms:.3f}x the "
          f"engine's wall); the frame's march alone on 157 blocks took "
          f"~95 ms (PERF.md §5), a pooled batch's march here p50 "
          f"{st['march_ms_p50']:.1f} ms", flush=True)

    # (a) identity: every tier off, no prefetch
    ident, st_i, ms_i, _ = serve_run(fields, acfg, serve_config(False),
                                     serve_requests(cams), dev)
    serve_reading("identity (tiers off, prefetch 0)", ident, st_i, ms_i)
    a_bad = [rid for rid, r in ident.items()
             if not (np.array_equal(r.image, single[rid][0])
                     and r.stats["samples_processed"] == single[rid][1]
                     and r.stats["probe_samples"] == single[rid][2])]
    print(f"[serve] gate (a): every request bit-equal to render_asdr_image "
          f"(image, samples, probe samples): {not a_bad}", flush=True)
    if a_bad:
        raise AssertionError(f"[serve] gate (a): requests {a_bad} differ "
                             f"from render_asdr_image")

    # (b) executor invariance
    runs = {"prefetch 0": serve_run(fields, acfg, dataclasses.replace(
        full, prefetch=0), serve_requests(cams), dev),
        "prefetch 2, workers 2": serve_run(fields, acfg, dataclasses.replace(
            full, workers=2), serve_requests(cams), dev)}
    for tag, (d, s, m, _) in runs.items():
        serve_reading(f"full, {tag}", d, s, m)
    inflight_i = serve_run(fields, acfg, serve_config(False, inflight_batches=2),
                           serve_requests(cams), dev)
    serve_reading("identity, inflight 2", *inflight_i[:3])
    inflight_f = serve_run(fields, acfg, dataclasses.replace(
        full, inflight_batches=2), serve_requests(cams), dev)
    serve_reading("full, inflight 2", *inflight_f[:3])
    b_ok = {tag: same_serving(done, d, st, s)
            for tag, (d, s, _, _) in runs.items()}
    b_ok["identity, inflight 2"] = same_serving(ident, inflight_i[0], st_i,
                                                inflight_i[1])
    f_same = same_serving(done, inflight_f[0], st, inflight_f[1])
    print(f"[serve] gate (b): bit-identical frames and counters against the "
          f"prefetch-2 run {b_ok}; full configuration at inflight 2 (moves "
          f"when frames finish, so what later admissions find cached; not "
          f"gated): same {f_same}, counters "
          f"{ {c: inflight_f[1][c] for c in DETERMINISTIC_COUNTERS} }",
          flush=True)
    if not all(b_ok.values()):
        raise AssertionError(f"[serve] gate (b): {b_ok}")
    wide = serve_run(fields, acfg, dataclasses.replace(
        full, blocks_per_batch=SERVE_WIDE_BATCH), serve_requests(cams), dev)
    serve_reading(f"full, blocks of {SERVE_WIDE_BATCH} a batch", *wide[:3])
    plain_w = runs["prefetch 2, workers 2"]
    del runs, inflight_i, inflight_f, wide

    # (c) tracing, with the worker streams on
    traced = serve_run(fields, acfg, dataclasses.replace(full, workers=2),
                       serve_requests(cams), dev, trace=True)
    spans, origin = traced[3]
    export = json.loads(json.dumps(obs.export.chrome_trace(
        spans, origin, 0), default=str))
    bad = check_trace.validate(export)
    lanes = {s.lane for s in spans if s.name == "executor.run"}
    disp = {s.attrs["batch"]: s.attrs["reqs"] for s in spans
            if s.name == "pool.dispatch"}
    coll = {s.attrs["batch"]: s.attrs["reqs"] for s in spans
            if s.name == "pool.collect"}
    c_ok = (same_serving(plain_w[0], traced[0], plain_w[1], traced[1])
            and not bad and lanes and all(l.startswith("serve-stage-a")
                                          for l in lanes)
            and disp and disp == coll)
    by_name = {}
    for sp in spans:
        n, t = by_name.get(sp.name, (0, 0.0))
        by_name[sp.name] = (n + 1, t + sp.dur_ms)
    print(f"[serve] gate (c): traced run (workers 2, {traced[2]:.1f} ms) "
          f"bit-identical to the untraced ({plain_w[2]:.1f} ms): "
          f"{same_serving(plain_w[0], traced[0], plain_w[1], traced[1])}; "
          f"{len(export['traceEvents'])} events, {len(bad)} schema findings; "
          f"executor.run lanes {sorted(lanes)}; {len(disp)} dispatch / "
          f"{len(coll)} collect batch ids matching: {disp == coll}; spans "
          f"{ {n: (c, round(t, 1)) for n, (c, t) in sorted(by_name.items())} }",
          flush=True)
    if not c_ok:
        raise AssertionError(f"[serve] gate (c): findings {bad[:3]}, lanes "
                             f"{lanes}, batches matching {disp == coll}")
    del plain_w, traced, spans, export

    # (d) viewer 0 alone on the plain field against the kernel field
    v0 = serve_requests(cams, viewers=("lego",))
    kern = serve_run({"lego": fields["lego"]}, acfg, full, v0, dev)
    plain = serve_run({"lego": model.field_fns(field_t)}, acfg, full,
                      serve_requests(cams, viewers=("lego",)), dev)
    gts = [ground_truth(scene_t, cam, dev) for cam in cams]
    worst, flags_eq = [0.0, 0.0, 0.0], True
    for k, gt in enumerate(gts):
        a, b = kern[0][k], plain[0][k]
        flags_eq &= all(a.stats[f] == b.stats[f] for f in SERVE_FLAGS)
        worst[0] = max(worst[0], abs(a.stats["rays_marched"]
                                     - b.stats["rays_marched"]) / R)
        worst[1] = max(worst[1], abs(a.stats["samples_processed"]
                                     - b.stats["samples_processed"])
                       / max(a.stats["samples_processed"], 1))
        worst[2] = max(worst[2], abs(
            float(rendering.psnr(torch.from_numpy(a.image).to(dev), gt))
            - float(rendering.psnr(torch.from_numpy(b.image).to(dev), gt))))
    print(f"[serve] gate (d): viewer 0 alone, kernel field {kern[2]:.1f} ms, "
          f"plain field {plain[2]:.1f} ms: flags equal {flags_eq}; worst "
          f"rays-marched gap {worst[0]:.3e} of the rays, samples gap "
          f"{worst[1]:.3e}, PSNR gap vs ground truth {worst[2]:.4f} dB",
          flush=True)
    if not (flags_eq and worst[0] == 0.0
            and worst[1] <= MAX_COUNT_DIFF and worst[2] <= MAX_PSNR_DIFF):
        raise AssertionError("[serve] gate (d): the plain field's requests "
                             "differ from the kernel field's")
    del kern, plain, gts

    # (e) two viewers replay the same lego poses through the block store
    store_only = serve_config(reuse=None, radiance=None)
    rp = serve_cams(hw, SERVE_REPLAY_POSES)
    alone, st_alone, _, _ = serve_run({"lego": fields["lego"]}, acfg,
                                      store_only, serve_requests(
                                          rp, viewers=("lego",)), dev)
    both, st_both, ms_both, _ = serve_run(
        {"lego": fields["lego"]}, acfg, store_only,
        serve_requests(rp, viewers=("lego", "lego")), dev)
    n_blocks = -(-R // B)
    second = [both[2 * k + 1] for k in range(SERVE_REPLAY_POSES)]
    first = [both[2 * k] for k in range(SERVE_REPLAY_POSES)]
    e_ok = (all(s.stats["scene_block_hits"] == n_blocks
                and s.stats["samples_processed"] == 0 for s in second)
            and st_both["blocks_marched"] == st_alone["blocks_marched"]
            and all(np.array_equal(f.image, s.image)
                    for f, s in zip(first, second)))
    serve_reading("store only, two viewers", both, st_both, ms_both)
    print(f"[serve] gate (e): the second viewer's {SERVE_REPLAY_POSES} "
          f"frames: block hits {[s.stats['scene_block_hits'] for s in second]}"
          f" of {n_blocks}, samples {[s.stats['samples_processed'] for s in second]}"
          f"; blocks marched {st_both['blocks_marched']} against "
          f"{st_alone['blocks_marched']} for the first viewer alone; frames "
          f"bit-equal to the first viewer's: "
          f"{all(np.array_equal(f.image, s.image) for f, s in zip(first, second))}",
          flush=True)
    if not e_ok:
        raise AssertionError("[serve] gate (e): the second viewer marched or "
                             "its frames differ")
    del alone, both

    # device time by kernel, Stage A inline and on two worker streams
    for workers in (0, 2):
        report_device_time(
            f"[serve] full, workers {workers}", lambda: serve_run(
                fields, acfg, dataclasses.replace(full, workers=workers),
                serve_requests(cams), dev), dev, share_of="fused_march",
            overlap_of="fused_march")
    print(f"[serve] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


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
    report_device_time("[decoupled] frame", frame, dev)

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
                     nbytes=4 * (2 * R * S + 3 * R * A + 4 * R), exact=True)
    del out, out_p, sig, anch, dl, vr_rgb
    check_volume_render_ragged(dev)

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


def attention_bounds(dtype, flop, pairs, softcap):
    """The bf16 settings' second bound: the special-function units, one
    exp2 a pair and, with the softcap, tanhf's exp2 and reciprocal."""
    import torch
    if dtype != torch.bfloat16:
        return ""
    sfu = pairs * (3 if softcap else 1)
    return (f"; bound on the dense bf16 tensor cores "
            f"{1e3 * flop / PEAK_BF16_TC:.3f} ms, on the special-function "
            f"units {1e3 * sfu / PEAK_SFU:.3f} ms ({sfu / 1e9:.2f} G ops)")


def check_volume_render_ragged(dev):
    """volume_render bit for bit against its plain version at the
    RAGGED_RENDERS shapes, with aligned inputs and with sigma and the
    anchors one float off 16-B alignment (the kernel's 4-B copies)."""
    import numpy as np
    import torch
    from repro_torch.kernels import volume_render as VR

    rng = np.random.default_rng(SEED)

    def shifted(t):     # the same values, one float past a 16-B boundary
        flat = torch.empty(t.numel() + 1, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    for R, S, A, g in RAGGED_RENDERS:
        sig, dl = (torch.from_numpy(rng.uniform(0, hi, (R, S)).astype(
            np.float32)).to(dev) for hi in (8.0, 0.05))
        anch = torch.from_numpy(rng.uniform(size=(R, A, 3)).astype(
            np.float32)).to(dev)
        want = VR.volume_render_plain(sig, dl, anch, g)
        same = [torch.equal(VR.volume_render(*x, g), want)
                for x in ((sig, dl, anch), (shifted(sig), dl, shifted(anch)))]
        print(f"[decoupled] volume_render on R={R} S={S} A={A} group {g}, "
              f"aligned / shifted inputs: bit-equal {same}", flush=True)
        if not all(same):
            raise AssertionError("volume_render differs from its plain "
                                 "version at a ragged shape")


def run_attention(cfg, seq, dev, reps=3):
    """Flash attention at ``cfg``'s attention widths on one sequence of
    ``seq`` tokens: the local layer, the global layer, the global layer
    without softcap (the library's case) in fp32, the local layer and the
    global layer without softcap in bf16 (the latter against SDPA in bf16
    too).  Returns the fp32 no-softcap row and the kernel's launches on
    the path."""
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
                ("local bf16", bf16, cfg.window, cfg.attn_softcap),
                ("global no softcap bf16", bf16, 0, 0.0)]
    outs, launches = path_launches(("flash_attention",), lambda: [
        FA.flash_attention(*x, window=w, softcap=c) for _, x, w, c in settings])
    row = None
    for (tag, x, w, c), out in zip(settings, outs):
        dt = x[0].dtype
        rtol, atol, rel = ATTN_TOL["bf16" if dt == torch.bfloat16 else "fp32"]
        _, ms = timed(lambda: FA.flash_attention(*x, window=w, softcap=c), dev,
                      reps)
        want, plain_ms = timed(lambda: FA.flash_attention_plain(*x, w, c),
                               dev, 1)
        pairs = B * H * sum(min(i + 1, w or S) for i in range(S))
        flop = 4 * Dh * pairs
        nbytes = x[0].element_size() * 2 * (x[0].numel() + x[1].numel())
        lib_ms = None
        if not c and not w:
            qt, kt, vt = (t.transpose(1, 2) for t in x)
            lib, lib_ms = timed(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), dev, reps)
            print(f"[attention] {tag}: scaled_dot_product_attention "
                  f"{lib_ms:.3f} ms, max_abs_err against the kernel "
                  f"{max_err(lib.transpose(1, 2), out)[0]:.3e}", flush=True)
            del lib
        print(f"[attention] {tag} (window {w}, softcap {c}, {dt}): "
              f"{pairs} causal pairs, {flop / 1e9:.1f} GFLOP"
              f"{attention_bounds(dt, flop, pairs, c)}", flush=True)
        args = (out, want, ms, plain_ms, flop, nbytes)
        peak = PEAK_BF16_TC if dt == torch.bfloat16 else PEAK_FP32
        if tag == "global no softcap":
            row = kernel_row("flash_attention", "flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:86", *args,
                             library_ms=lib_ms, rtol=rtol, atol=atol, rel=rel)
        else:
            check(f"flash_attention {tag}", *args, library_ms=lib_ms,
                  rtol=rtol, atol=atol, peak=peak, rel=rel)
        del want
    check_attention_ragged(dev)
    return row, launches


def check_attention_ragged(dev):
    """Flash attention at shapes the attention phase does not give it:
    RAGGED_SEQ tokens (a multiple of neither query tile), head_dim 64,
    H / KV = 1 and 8, global and with a window that starts mid-tile and the
    softcap, in both dtypes, against the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA

    rng = np.random.default_rng(SEED)
    for H, KV in ((8, 8), (8, 1)):
        shapes = ((2, RAGGED_SEQ, H, 64), (2, RAGGED_SEQ, KV, 64),
                  (2, RAGGED_SEQ, KV, 64))
        x32 = [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
               .to(dev) for sh in shapes]
        for x in (x32, [t.to(torch.bfloat16) for t in x32]):
            dt = "bf16" if x[0].dtype == torch.bfloat16 else "fp32"
            for w, c in ((0, 0.0), (RAGGED_WINDOW, 30.0)):
                got = FA.flash_attention(*x, window=w, softcap=c)
                want = FA.flash_attention_plain(*x, w, c)
                rtol, atol, rel = ATTN_TOL[dt]
                err, ok = max_err(got, want, rtol, atol)
                r = rel_norm_err(got, want)
                ok = ok and (rel is None or r <= rel)
                print(f"[attention] ragged: S {RAGGED_SEQ}, H {H}, KV {KV}, "
                      f"head_dim 64, {dt}, window {w}, softcap {c}: "
                      f"max_abs_err={err:.3e} rel_norm_err={r:.3e}",
                      flush=True)
                if not ok:
                    raise AssertionError("flash_attention disagrees with its "
                                         "plain version at a ragged shape")


def run(dev, bundle, hw, attn, seq, reps=3, train_kw=TRAIN):
    """Phases 2-8 on ``dev`` at ``bundle``, image size ``hw``, attention
    widths ``attn``, ``seq`` tokens and training ``train_kw``; returns the
    kernel rows of the JSON line."""
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
    field_t, scene_t = run_train(bundle, cam, dev, train_kw)
    run_reuse(field_t, scene_t, bundle, dev, hw)
    run_serve(field_t, scene_t, field, bundle, dev, hw)
    rows += [vr_row, fa_row]
    launches.update(**frame_launches, **vr_launches, **fa_launches)
    for r in rows:
        r["launches"] = launches[r["name"]]
    return rows


def ptxas_lines(log):
    """[(kernel, line)] of ptxas -v's stack-frame / spill and register
    lines, each with the kernel it belongs to."""
    out, fn = [], "?"
    for line in log.splitlines():
        line = line.strip()
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        elif "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line:
            out.append((fn, line.replace("ptxas info    : ", "")))
    return out


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
    checked, registers = set(), {}
    for name, info in built.items():
        for fn, line in ptxas_lines(info["ptxas"]):
            print(f"[build] {name} {fn}: {line}", flush=True)
            kernel = next((k for k in TILE_KERNELS if k in fn), None)
            if kernel is None:
                continue
            if line.startswith("Used "):
                registers[kernel] = int(line.split()[1])
            if "stack frame" in line:
                if not line.startswith("0 bytes stack frame, 0 bytes spill "
                                       "stores, 0 bytes spill loads"):
                    raise AssertionError(f"{fn}: ptxas reports {line}")
                checked.add(kernel)
    missing = [k for k, src in TILE_KERNELS.items()
               if src in built and k not in checked]
    if missing:
        raise AssertionError(f"ptxas reported nothing for {missing}")
    print(f"[build] 0-byte stacks, no spills; registers {registers}",
          flush=True)

    dev = torch.device("cuda")
    bundle = ingp_asdr.CONFIG
    check_smem(bundle, gemma2_27b.CONFIG)
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
