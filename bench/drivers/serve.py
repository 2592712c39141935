"""The render server in closed-loop rounds: ``viewers_per_scene`` viewers
of each of ``scenes`` send one request each a round, and each round is
one ``RenderServingEngine.render`` call carrying every viewer's next
pose; the next round starts when it returns.

Traffic parameters (``bench/traffic/<name>.json``): ``scenes``,
``viewers_per_scene``, ``radius``, the pose ranges (``inputs/poses.py``),
the ``engine`` settings (slots, blocks a batch, prefetch, Stage-A
workers, the scene store's MiB), ``tiers``, the reuse tiers that are on,
and ``fresh_within``.  Every request takes the next pose of its scene's
R2 sequence; any two poses of a scene fewer than ``fresh_within``
requests apart lie beyond the probe tier's reach (a CPU test checks
every position of the sequence), and the tiers remember fewer poses than
that (``engine`` refuses to start otherwise), so no tier can hit however
long the window runs, and every frame is marched afresh (the check holds
the engine to that).  The warm-up round takes the sequences' first
poses, so the window continues them.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from bench import port
from bench.drivers.frames import make_camera, reference_render, sync
from bench.inputs import field as field_lib
from bench.inputs import poses as poses_lib
from bench.reference import compare

WARM_ROUNDS = 1
POSES_AHEAD = 4096
# A pixel whose colour lies further than this from the reference's is
# not float noise: the frames cells' sound frames differ by at most
# 7.2e-7 where their block budgets agree (H100, fitted lego).
PIXEL_GAP = 1e-5


class Viewers:
    """The pose of each viewer's next request, scene by scene."""

    def __init__(self, traffic: dict, seed: int):
        self.traffic, self.seed = traffic, seed
        self.poses = {scene: [] for scene in traffic["scenes"]}
        self.taken = dict.fromkeys(traffic["scenes"], 0)

    def next_round(self):
        """[(scene, pose)] for every viewer, scene by scene."""
        out = []
        for s, scene in enumerate(self.traffic["scenes"]):
            for _ in range(self.traffic["viewers_per_scene"]):
                k = self.taken[scene]
                if k == len(self.poses[scene]):
                    self.poses[scene] = poses_lib.r2_poses(
                        self.traffic, self.seed, k + POSES_AHEAD, stream=s)
                out.append((scene, self.poses[scene][k]))
                self.taken[scene] = k + 1
        return out


def engine(fields: dict, cfg: dict, traffic: dict, device):
    from repro_torch.scenecache import SceneBlockCache, SceneCacheConfig
    from repro_torch.serve.render_engine import (
        ProbeReuseConfig, RadianceReuseConfig, RenderServeConfig,
        RenderServingEngine)

    e, tiers = traffic["engine"], set(traffic["tiers"])
    rcfg = RenderServeConfig(
        slots=e["slots"], blocks_per_batch=e["blocks_per_batch"],
        prefetch=e["prefetch"], workers=e["workers"],
        reuse=ProbeReuseConfig() if "probe" in tiers else None,
        radiance=RadianceReuseConfig() if "radiance" in tiers else None)
    remembered = max([0] + [t.max_entries for t in (rcfg.reuse, rcfg.radiance)
                            if t is not None])
    if (remembered + traffic["viewers_per_scene"] + traffic["cycle"]
            > traffic["fresh_within"]):
        raise RuntimeError(
            f"the reuse tiers keep {remembered} poses a scene: more than "
            f"the {traffic['fresh_within']} requests over which the traffic's "
            f"poses are checked to stay apart (bench/tests), so a tier "
            f"could hit; check the poses over more requests")
    store = (SceneBlockCache(SceneCacheConfig(
        byte_budget=e["store_mib"] << 20)) if "scene" in tiers else None)
    return RenderServingEngine(
        {name: port.kernel_field(cfg, p) for name, p in fields.items()},
        port.asdr_config(cfg), rcfg, scenecache=store, device=device)


class ControlEngine:
    """The control in the engine's place: each request's frame rendered by
    the reference with its matmuls in TF32, one after another, marched
    whole (no tier)."""

    def __init__(self, fields: dict, cfg: dict, device):
        self.renders = {name: reference_render(p, cfg, device, lower=True)
                        for name, p in fields.items()}
        self.counters = SimpleNamespace(pad_blocks=0, blocks_marched=0,
                                        rays_marched=0, rays_total=0)

    def render(self, requests):
        t0 = time.time()
        for req in requests:
            out = self.renders[req.scene](req.cam)
            req.image = out["image"].cpu().numpy()
            rays = req.cam.height * req.cam.width
            req.stats = {"admit_stall_s": 0.0, "probe_reused": False,
                         "radiance_reused": False, "probe_skipped": False,
                         "scene_block_hits": 0, "rays_marched": rays,
                         "rays_total": rays,
                         "probe_samples": out["probe_samples"]}
            req.latency_s = time.time() - t0
        return requests

    def close(self):
        pass


def counters(eng) -> dict:
    c = eng.counters
    return {"pad_blocks": c.pad_blocks, "blocks_marched": c.blocks_marched,
            "rays_marched": c.rays_marched, "rays_total": c.rays_total}


def setup(ctx):
    cfg, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    t0 = time.perf_counter()
    fields = field_lib.make_fields(cfg, traffic["scenes"], ctx.seed, dev,
                                   ctx.fits)
    sync(dev)
    t1 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = {"ctx": ctx, "fields": fields, "rid": 0,
             "viewers": Viewers(traffic, ctx.seed),
             "engine": (engine(fields, cfg, traffic, dev)
                        if ctx.control is None
                        else ControlEngine(fields, cfg, dev))}
    for _ in range(WARM_ROUNDS if ctx.control is None else 0):
        serve_round(state)
    sync(dev)
    state["setup_parts"] = {"fields_s": t1 - t0,
                            "warm_s": time.perf_counter() - t1}
    return state


def serve_round(state):
    """One round: every viewer's next request, served; returns the
    requests with their cameras."""
    from repro_torch.serve.render_engine import RenderRequest

    ctx = state["ctx"]
    cams, reqs = {}, []
    for scene, pose in state["viewers"].next_round():
        cam = make_camera(ctx.cell.config, ctx.cell.traffic, pose)
        reqs.append(RenderRequest(rid=state["rid"], scene=scene,
                                  cam=port.camera(cam)))
        cams[state["rid"]] = (scene, cam)
        state["rid"] += 1
    done = state["engine"].render(reqs)
    return [(req, *cams[req.rid]) for req in done], len(reqs)


def window(state, seconds: float) -> dict:
    ctx = state["ctx"]
    n_check = ctx.cell.workload["check"]["frames"]
    pick = poses_lib.seeded_rng(ctx.seed, 3)
    eng = state["engine"]
    before = counters(eng)
    kept, latency, stall = [], [], []
    attempted = delivered = 0
    t_start = time.perf_counter()
    while True:
        done, sent = serve_round(state)
        t1 = time.perf_counter()
        attempted += sent
        for req, scene, cam in done:
            latency.append(req.latency_s)
            stall.append(req.stats["admit_stall_s"])
            if len(kept) < n_check:
                kept.append((delivered, req, scene, cam))
            else:
                j = int(pick.integers(0, delivered + 1))
                if j < n_check:
                    kept[j] = (delivered, req, scene, cam)
            delivered += 1
        if t1 - t_start >= seconds:
            break
    after = counters(eng)
    state["kept"] = sorted(kept, key=lambda t: t[0])
    delta = {k: after[k] - before[k] for k in after}
    return {"frames": delivered, "window_s": t1 - t_start,
            "latency_s": latency, "admit_stall_s": stall,
            "counters": delta, "attempted": attempted,
            "failed": attempted - delivered}


def check(state, obs) -> dict:
    """Each sampled delivered frame against the reference's frame of its
    camera, and its reuse outcome and probe counter: no tier may hit,
    since no pose comes within a tier's reach of one it remembers (the
    module's docstring), so each frame is probed and marched whole."""
    ctx = state["ctx"]
    cfg, dev = ctx.cell.config, ctx.device
    state["engine"].close()
    state["engine"] = None
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    refs = {name: reference_render(p, cfg, dev)
            for name, p in state["fields"].items()}
    readings = []
    for _, req, scene, cam in state["kept"]:
        img = torch.as_tensor(np.asarray(req.image), device=dev).reshape(-1, 3)
        st = req.stats
        ref = refs[scene](cam)
        reused = (st["probe_reused"] or st["radiance_reused"]
                  or st["probe_skipped"] or st["scene_block_hits"] > 0
                  or st["rays_marched"] != st["rays_total"])
        readings.append(dict(
            serve_numbers(img, ref, cfg), reuse_mismatch=float(reused),
            probe_gap=float(abs(st["probe_samples"] - ref["probe_samples"]))))
    return compare.worst(readings)


def serve_numbers(img, ref, cfg) -> dict:
    """A served frame against the reference's: the 90th percentile pixel
    gap, the share of pixels further than ``PIXEL_GAP`` off, and the share
    of the reference's blocks holding such a pixel.  A served frame
    carries no count map, so a pixel whose count rounded the other way,
    and the block it moves, show here as off."""
    R = img.shape[0]
    gap = torch.abs(img.float() - ref["image"].reshape(R, 3)).max(dim=-1)
    gap = torch.nan_to_num(gap.values, nan=float("inf"))
    B = cfg["asdr"]["block_size"]
    pad = (-R) % B
    order = torch.argsort(torch.cat([
        ref["counts"].to(torch.int32),
        torch.full((pad,), min(cfg["asdr"]["candidates"]), dtype=torch.int32,
                   device=img.device)]), stable=True)
    far = torch.cat([gap > PIXEL_GAP,
                     torch.zeros((pad,), dtype=torch.bool, device=img.device)])
    blocks_off = far[order].reshape(-1, B).any(dim=1)
    return {"rgb_p90_err": float(torch.quantile(gap, 0.9)),
            "pixel_mismatch": float(far.float().sum()) / R,
            "block_mismatch": float(blocks_off.float().mean())}
