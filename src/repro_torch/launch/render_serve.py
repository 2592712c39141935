"""Render-serve launcher: the pooled multi-view render serving engine,
end to end on analytic scenes over a camera trajectory
(``repro.launch.render_serve``, its concrete mode):

    PYTHONPATH=src python -m repro_torch.launch.render_serve --device cpu \
        --poses 4 --size 24

runs on the CPU; without ``--device`` it runs on the GPU (``cuda``).
The scenes are analytic, so no kernel runs here; ``chip_smoke.py``
drives the engine through the kernel field.  The reference's dry-run
(``--dryrun``, ``--multi-pod``: the pooled march compiled on a forced
production mesh) is not ported.
"""
import argparse
import dataclasses
import time

import numpy as np


def scenecache_smoke(size: int = 16, poses: int = 3, clients: int = 2,
                     budget_bytes: int = 4 << 20, device=None) -> dict:
    """Tiny concrete scene-block-reuse run on ``device`` (the GPU unless
    ``device="cpu"``).

    ``clients`` request streams replay the SAME poses of one scene
    through an engine whose only reuse tier is the shared scene-space
    block store — the cross-client hit rate, resident bytes, and eviction
    count land next to the compile-cell numbers so the serving record
    carries both halves of the story (march cost AND reuse).
    """
    from repro_torch.core import fields, pipeline, scene
    from repro_torch.scenecache import SceneCacheConfig
    from repro_torch.serve.render_engine import (RenderRequest,
                                                 RenderServeConfig,
                                                 RenderServingEngine)

    acfg = pipeline.ASDRConfig(ns_full=48, probe_stride=4,
                               candidates=(8, 16, 32), block_size=64,
                               chunk=16, sort_by_opacity=False)
    flds = {"mic": fields.analytic_field_fns(scene.make_scene("mic"))}
    eng = RenderServingEngine(flds, acfg, RenderServeConfig(
        slots=2, blocks_per_batch=4, reuse=None,
        scenecache=SceneCacheConfig(byte_budget=budget_bytes)),
        device=device)
    reqs = [RenderRequest(rid=c * poses + i, scene="mic",
                          cam=scene.look_at_camera(size, size,
                                                   theta=0.6 + 0.05 * i,
                                                   phi=0.5))
            for c in range(clients) for i in range(poses)]
    eng.render(reqs)
    st = eng.engine_stats()
    eng.close()
    return {
        "clients": clients, "poses": poses, "size": size,
        "scene_block_hits": st["scene_block_hits"],
        "scene_block_hit_rate": st["scene_block_hit_rate"],
        "blocks_marched": st["blocks_marched"],
        **{k: st["scenecache"][k]
           for k in ("resident_bytes", "byte_budget", "evictions",
                     "entries")},
    }


def _concrete(args):
    from repro_torch.core import fields, pipeline, scene
    from repro_torch.framecache import ProbeReuseConfig, RadianceReuseConfig
    from repro_torch.scenecache import SceneCacheConfig, ShardedSceneCache
    from repro_torch.serve.render_engine import (RenderRequest,
                                                 RenderServeConfig,
                                                 RenderServingEngine,
                                                 RequestClass)

    acfg = pipeline.ASDRConfig(
        ns_full=96, probe_stride=4, candidates=(12, 24, 48),
        block_size=args.block, chunk=16, sort_by_opacity=True)
    flds = {s: fields.analytic_field_fns(scene.make_scene(s))
            for s in ("mic", "hotdog")}
    # --shards > 1 shares one sharded store INSTANCE (the fleet form);
    # otherwise the engine builds its own plain store from the config
    sc_cfg = (SceneCacheConfig(byte_budget=int(args.scenecache_mb * (1 << 20)))
              if args.scenecache_mb > 0 else None)
    shared = (ShardedSceneCache(sc_cfg, shards=args.shards)
              if sc_cfg is not None and args.shards > 1 else None)
    if args.march_backend != "reference":
        acfg = dataclasses.replace(acfg, march_backend=args.march_backend)
    # observability switchboard: any of --trace / --trace-jsonl /
    # --metrics-jsonl / --flight-recorder turns the tracer on; all off
    # (the default) keeps every call site on the null-span fast path
    tcfg = None
    if (args.trace or args.trace_jsonl or args.metrics_jsonl
            or args.flight_recorder):
        from repro_torch.obs import TraceConfig
        tcfg = TraceConfig(
            path=args.trace, jsonl=args.trace_jsonl,
            metrics_jsonl=args.metrics_jsonl,
            flight=args.flight_recorder,
            stall_dump_ms=args.stall_dump_ms)
    eng = RenderServingEngine(flds, acfg, RenderServeConfig(
        slots=args.slots, blocks_per_batch=args.blocks_per_batch,
        reuse=ProbeReuseConfig(),
        radiance=None if args.no_radiance else RadianceReuseConfig(),
        scenecache=None if shared is not None else sc_cfg,
        prefetch=args.prefetch, workers=args.workers,
        devices=args.devices, inflight_batches=args.inflight_batches,
        density_refresh=args.density_refresh, trace=tcfg,
        policy=args.policy),
        scenecache=shared, device=args.device)

    # SLO knobs: --deadline-ms attaches a deadline class (with a degrade
    # ladder the shed policy may walk); --arrival-rate replays the poses
    # as open-loop Poisson traffic instead of an all-at-once queue
    cls = (RequestClass("rt", deadline_ms=args.deadline_ms,
                        tiers=(1.0, 0.5, 0.25), shed_floor=2)
           if args.deadline_ms > 0 else None)
    arrivals = np.zeros(args.poses)
    if args.arrival_rate > 0:
        rng = np.random.default_rng(7)
        arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                             args.poses))
    reqs = []
    for i in range(args.poses):
        sc = "mic" if i % 2 == 0 else "hotdog"   # interleaved multi-scene
        reqs.append(RenderRequest(
            rid=i, scene=sc,
            cam=scene.look_at_camera(args.size, args.size,
                                     theta=0.6 + 0.01 * (i // 2), phi=0.5),
            arrival_s=float(arrivals[i]),
            **({"cls": cls} if cls is not None else {})))
    t0 = time.time()
    done = eng.render(reqs)
    dt = time.time() - t0
    st = eng.engine_stats()
    print(f"[render_serve] {len(done)} frames {args.size}x{args.size} in "
          f"{dt:.2f}s = {len(done)/dt:.2f} fps")
    print(f"  reused-probe fraction : {st['reused_probe_fraction']:.2f} "
          f"({st['probe_hits']} hits + {st['probe_skips']} skips / "
          f"{st['probe_misses']} probes; "
          f"{st['full_radiance_hits']} full radiance hits)")
    # first-class engine ledgers (stats.py Series) — no per-launcher
    # re-aggregation of RenderRequest fields
    print(f"  latency               : p50 {st['latency_ms_p50']:.1f} ms  "
          f"p99 {st['latency_ms_p99']:.1f} ms (end-to-end, "
          f"{st['frames']} frames)")
    print(f"  admission stall       : p50 {st['admit_stall_ms_p50']:.1f} ms  "
          f"p99 {st['admit_stall_ms_p99']:.1f} ms "
          f"(prefetch {args.prefetch}, workers {args.workers}, "
          f"{st['misprepares']} misprepares)")
    print(f"  radiance reuse        : {st['reused_radiance_fraction']:.2f} "
          f"of frames, rays marched "
          f"{100 * st['rays_marched_fraction']:.1f}% of total")
    print(f"  pooled batches        : {st['batches']} "
          f"(pad fraction {st['pad_block_fraction']:.2f})")
    print(f"  march rounds          : {st['march_rounds']} "
          f"(march p50 {st['march_ms_p50']:.1f} ms  "
          f"p99 {st['march_ms_p99']:.1f} ms; batches/round "
          f"{st['batches_per_round']})")
    if cls is not None or args.policy not in (None, "fifo"):
        print(f"  scheduler ({args.policy:<5})   : "
              f"{st['requests_shed']} shed / {st['requests_full']} full "
              f"({st['shed_degrades']} degrade steps, "
              f"{st['shed_reprepares']} re-prepares), "
              f"{st['deadline_misses']} deadline misses")
        for name, led in st["class_stats"].items():
            print(f"    class {name:<12}: {led['frames']} frames  "
                  f"p50 {led['latency_ms_p50']:.1f} ms  "
                  f"p99 {led['latency_ms_p99']:.1f} ms  "
                  f"({led['shed']} shed, {led['deadline_misses']} missed)")
    if eng.scenecache is not None:
        sc = st["scenecache"]
        print(f"  scene-block reuse     : hit rate "
              f"{st['scene_block_hit_rate']:.2f} "
              f"({st['scene_block_hits']} hits), resident "
              f"{sc['resident_bytes'] / (1 << 20):.2f} MB / "
              f"{sc['byte_budget'] / (1 << 20):.0f} MB budget, "
              f"{sc['evictions']} evictions")
    marched = [r for r in done if r.stats["rays_marched"]]
    mean_frac = np.mean([r.stats["samples_processed"]
                         / r.stats["baseline_samples"]
                         for r in marched]) if marched else 0.0
    print(f"  phase-II samples      : {100 * mean_frac:.1f}% of fixed-"
          f"{acfg.ns_full} baseline (marched frames)")
    if args.stats:
        import json
        print(json.dumps(st, indent=2, default=str))
    eng.close()      # flush + export the trace (no-op with tracing off)
    if tcfg is not None:
        for label, p in (("trace", tcfg.path), ("span log", tcfg.jsonl),
                         ("metrics", tcfg.metrics_jsonl)):
            if p:
                print(f"  wrote {label:<9}: {p}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the device the engine runs on (cuda, or cpu)")
    ap.add_argument("--poses", type=int, default=10)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--blocks-per-batch", type=int, default=16)
    ap.add_argument("--no-radiance", action="store_true",
                    help="disable warped-radiance reuse (probe reuse stays)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="Stage-A admission lookahead depth (0 = fully "
                         "synchronous admission)")
    ap.add_argument("--workers", type=int, default=0,
                    help="Stage-A executor worker threads (0 = synchronous "
                         "executor; N overlaps probe/warp device work with "
                         "the in-flight march on N threads, a CUDA stream "
                         "each)")
    ap.add_argument("--devices", type=int, default=0,
                    help="place Stage-A speculation on up to N secondary "
                         "cards (0 = off; takes precedence over --workers; "
                         "the synchronous executor on a one-card host)")
    ap.add_argument("--inflight-batches", type=int, default=1,
                    help="batches dispatched per scheduling round (the "
                         "streaming scheduler; >1 lets the next-largest "
                         "scene group fill idle launches)")
    ap.add_argument("--march-backend", choices=("reference", "fused"),
                    default="reference",
                    help="Phase-II march backend; 'fused' runs the "
                         "single-kernel CUDA march for FieldFns that "
                         "carry fused resources (analytic fields keep the "
                         "reference march)")
    ap.add_argument("--density-refresh", action="store_true",
                    help="march warp-served rays through the color-free "
                         "density march so warped frames regain exact "
                         "acc/depth and re-enter the radiance cache")
    ap.add_argument("--stats", action="store_true",
                    help="dump the full engine_stats() dict as JSON "
                         "(includes march_ms percentiles and the "
                         "batches-per-round histogram)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace JSON on exit "
                         "(open at ui.perfetto.dev); enables the tracer")
    ap.add_argument("--trace-jsonl", default=None, metavar="PATH",
                    help="write the raw span log as JSONL on exit")
    ap.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                    help="append periodic metrics-registry snapshots "
                         "(one JSON object per line) during serving")
    ap.add_argument("--flight-recorder", action="store_true",
                    help="keep a bounded in-memory ring of recent spans "
                         "(with --stall-dump-ms: dump it to a trace file "
                         "the first time an admission stalls past the "
                         "threshold)")
    ap.add_argument("--stall-dump-ms", type=float, default=None,
                    help="arm the flight recorder to dump on the first "
                         "admission.wait span exceeding this many ms")
    ap.add_argument("--policy", choices=("fifo", "edf", "shed"),
                    default="fifo",
                    help="admission policy (serve/scheduler.py): 'fifo' "
                         "is the bit-identical default, 'edf' drains "
                         "slots earliest-deadline-first, 'shed' adds "
                         "sample-budget load-shedding under overload")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="attach a per-frame deadline class to every "
                         "request (tiers 1.0/0.5/0.25, shed floor at "
                         "0.25); 0 = no deadline (nothing ever sheds)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrivals at this rate in "
                         "requests/s (seeded); 0 = closed loop, every "
                         "request enqueued at t=0")
    ap.add_argument("--scenecache-mb", type=float, default=0.0,
                    help="enable scene-space block reuse with this byte "
                         "budget in MB (0 = off)")
    ap.add_argument("--shards", type=int, default=1,
                    help="shard the scene cache N ways (with "
                         "--scenecache-mb; >1 uses the fleet-shared "
                         "ShardedSceneCache routed by key bytes)")
    _concrete(ap.parse_args())


if __name__ == "__main__":
    main()
