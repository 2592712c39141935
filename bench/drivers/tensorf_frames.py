"""Closed-loop frames of a TensoRF VM field: ``frames.py``'s viewer, one
``core.pipeline.render_asdr_image`` a frame, on the port's VM field
(``kernels.ops.tensorf_field_fns``: Phase I on library operations, Phase
II through the VM march kernel), each frame at the next pose of the
traffic's sequence.

Traffic parameters as ``frames.py``'s.  The fitted VM field comes from
``inputs/field_tensorf.py``, the reference from ``reference/tensorf.py``
through ``reference/asdr.py``; the window's work is reckoned by
``metrics/_work_vm.py``.

Controls (the reference in the program's place, ``Context.control``):
"tf32", its matmuls in TF32, which reaches only the appearance chain,
since VM density has no matmul; and "density-tf32" / "density-bf16", the
density planes and lines rounded to TF32's (fp16's) 10-bit or bf16's
7-bit mantissa, everything else in fp32, for the numbers that only the
density path moves (``ray_chunk_diff``, ``depth_max_err``).
"""
from __future__ import annotations

import time

import torch
# the port's VM field: a checkout without it fails here, before the fit
from repro_torch.core import tensorf

from bench import port
from bench.drivers import frames
from bench.inputs import field_tensorf
from bench.inputs import poses as poses_lib
from bench.metrics import _work_vm
from bench.reference import asdr as ref_asdr
from bench.reference import compare
from bench.reference import tensorf as ref_tensorf


# mantissa bits the density controls keep of fp32's 23
DENSITY_CONTROLS = {"density-tf32": 10, "density-bf16": 7}


def round_mantissa(t, bits: int):
    """fp32 ``t`` rounded to ``bits`` mantissa bits, to nearest, ties to
    even."""
    drop = 23 - bits
    i = t.float().contiguous().view(torch.int32)
    i = (i + ((1 << (drop - 1)) - 1) + ((i >> drop) & 1)) & -(1 << drop)
    return i.view(torch.float32)


def reference_render(params, cfg, device, control: str | None = None):
    """The plain reference's frame of a camera; under a ``control``, in
    that lower precision."""
    if control in DENSITY_CONTROLS:
        params = dict(params, **{
            k: [round_mantissa(t, DENSITY_CONTROLS[control])
                for t in params[k]]
            for k in ("density_plane", "density_line")})
    elif control not in (None, "tf32"):
        raise ValueError(f"unknown control {control!r}")
    field = ref_tensorf.Field(params, cfg)
    lower = control == "tf32"

    def render(cam):
        frames.tf32(lower)
        try:
            with torch.no_grad():
                img, st = ref_asdr.render_frame(field, cfg, cam, device)
        finally:
            frames.tf32(False)
        return {"image": img, "counts": st["counts"],
                "budgets": st["budgets"], "chunks": st["chunks_per_block"],
                "ray_chunks": st["ray_chunks_per_block"],
                "depth": st["term_depth"], "probe_samples": st["probe_samples"]}
    return render


def tensorf_config(cfg: dict):
    t = cfg["tensorf"]
    return tensorf.TensoRFConfig(
        resolution=tuple(t["resolution"]),
        density_components=tuple(t["density_components"]),
        app_components=tuple(t["app_components"]), app_dim=t["app_dim"],
        fea_pe=t["fea_pe"], view_pe=t["view_pe"], hidden=t["hidden"],
        density_shift=t["density_shift"],
        distance_scale=t["distance_scale"], aabb_size=t["aabb_size"])


def program_render(params, cfg, device):
    from repro_torch.core.pipeline import render_asdr_image
    from repro_torch.kernels import ops

    copy = {k: ([x.clone() for x in v] if isinstance(v, list) else v.clone())
            for k, v in params.items()}
    fns = ops.tensorf_field_fns(tensorf.TensoRFField(tensorf_config(cfg),
                                                     copy))
    acfg = port.asdr_config(cfg)

    def render(cam):
        img, stats = render_asdr_image(fns, acfg, port.camera(cam),
                                       device=device)
        return port.frame_outputs(img, stats)
    return render


def setup(ctx):
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    t0 = time.perf_counter()
    params = field_tensorf.make_fields(cfg, [traffic["scene"]], ctx.seed, dev,
                                       ctx.fits)[traffic["scene"]]
    frames.sync(dev)
    t1 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    render = (program_render(params, cfg, dev) if ctx.control is None
              else reference_render(params, cfg, dev, ctx.control))
    for pose in poses_lib.r2_poses(traffic, ctx.seed, frames.WARM_FRAMES,
                                   stream=1):
        render(frames.make_camera(cfg, traffic, pose))
    frames.sync(dev)
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
            poses = poses_lib.r2_poses(traffic, ctx.seed,
                                       k + frames.POSES_AHEAD)
        cam = frames.make_camera(cfg, traffic, poses[k])
        t0 = time.perf_counter()
        out = render(cam)
        frames.sync(dev)
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
    work = [_work_vm.frame_work(cfg, b.tolist(), c.tolist(), p)
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
    frames.sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_render(state["params"], cfg, dev)
    readings = [compare.frame_numbers(out, ref(cam), cfg)
                for _, cam, out in state["kept"]]
    return compare.worst(readings)
