"""Closed-loop frames: one viewer renders one frame after another through
the port's ``core.pipeline.render_asdr_image`` on the kernel field with
the fused march, each frame at the next pose of the traffic's sequence.

Traffic parameters (``bench/traffic/<name>.json``): ``scene``, the
``radius`` of the orbit, the ``theta`` and ``phi`` ranges and
``phi_sampling`` (``inputs/poses.py``).  The cell's workload file gives
``check.frames``, how many of the window's frames the reference renders
again, drawn from the seed.
"""
from __future__ import annotations

import time

import torch

from bench import port
from bench.inputs import field as field_lib
from bench.inputs import poses as poses_lib
from bench.inputs import scenes
from bench.metrics import _work
from bench.reference import asdr as ref_asdr
from bench.reference import compare
from bench.reference import ngp as ref_ngp

WARM_FRAMES = 2
POSES_AHEAD = 4096


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def reference_render(params, cfg, device, lower: bool = False):
    """The plain reference's frame of a camera, as the comparison reads
    it; with ``lower``, its matmuls in TF32 (the control)."""
    field = ref_ngp.Field(params, cfg)

    def render(cam):
        tf32(lower)
        try:
            with torch.no_grad():
                img, st = ref_asdr.render_frame(field, cfg, cam, device)
        finally:
            tf32(False)
        return {"image": img, "counts": st["counts"],
                "budgets": st["budgets"], "chunks": st["chunks_per_block"],
                "ray_chunks": st["ray_chunks_per_block"],
                "depth": st["term_depth"], "probe_samples": st["probe_samples"]}
    return render


def program_render(params, cfg, device):
    from repro_torch.core.pipeline import render_asdr_image

    fns = port.kernel_field(cfg, params)
    acfg = port.asdr_config(cfg)

    def render(cam):
        img, stats = render_asdr_image(fns, acfg, port.camera(cam),
                                       device=device)
        return port.frame_outputs(img, stats)
    return render


def make_camera(cfg, traffic, pose):
    h, w = cfg["image_hw"]
    return scenes.look_at_camera(h, w, pose[0], pose[1],
                                 radius=traffic["radius"])


def setup(ctx):
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    t0 = time.perf_counter()
    params = field_lib.make_fields(cfg, [traffic["scene"]], ctx.seed, dev,
                                   ctx.fits)[traffic["scene"]]
    sync(dev)
    t1 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    render = (program_render(params, cfg, dev) if ctx.control is None
              else reference_render(params, cfg, dev, lower=True))
    for pose in poses_lib.r2_poses(traffic, ctx.seed, WARM_FRAMES, stream=1):
        render(make_camera(cfg, traffic, pose))
    sync(dev)
    return {"ctx": ctx, "params": params, "render": render,
            "setup_parts": {"fields_s": t1 - t0,
                            "warm_s": time.perf_counter() - t1}}


def window(state, seconds: float) -> dict:
    ctx = state["ctx"]
    cfg, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    n_check = ctx.cell.workload["check"]["frames"]
    pick = poses_lib.seeded_rng(ctx.seed, 3)
    kept = []                   # a reservoir sample of the frames
    frame_s, counters = [], []
    poses = []
    render = state["render"]
    t_start = time.perf_counter()
    k = 0
    while True:
        if k == len(poses):
            poses = poses_lib.r2_poses(traffic, ctx.seed, k + POSES_AHEAD)
        cam = make_camera(cfg, traffic, poses[k])
        t0 = time.perf_counter()
        out = render(cam)
        sync(dev)
        t1 = time.perf_counter()
        frame_s.append(t1 - t0)
        counters.append((out["budgets"], out["chunks"], out["probe_samples"]))
        if len(kept) < n_check:
            kept.append((k, cam, out))
        else:
            j = int(pick.integers(0, k + 1))
            if j < n_check:
                kept[j] = (k, cam, out)
        k += 1
        if t1 - t_start >= seconds:
            break
    state["kept"] = sorted(kept, key=lambda t: t[0])
    work = [_work.frame_work(cfg, b.tolist(), c.tolist(), p)
            for b, c, p in counters]
    return {"frames": k, "window_s": t1 - t_start, "frame_s": frame_s,
            "work": work, "ns_full": cfg["asdr"]["ns_full"],
            "attempted": k, "failed": 0}


def check(state, obs) -> dict:
    """The worst of each number over the sampled frames, each against the
    reference's frame of the same camera, rendered after the program's
    state is freed."""
    ctx = state["ctx"]
    cfg, dev = ctx.cell.config, ctx.device
    state["render"] = None
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_render(state["params"], cfg, dev)
    readings = [compare.frame_numbers(out, ref(cam), cfg)
                for _, cam, out in state["kept"]]
    return compare.worst(readings)
