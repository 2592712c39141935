"""Port: the multi-card render lane on the CPU — the counterparts of
``tests/test_fleet.py``, in the default tier.

The reference forces four JAX host devices (``make test-fleet``); the
port's ``executor._available_devices`` is a module hook, patched here to
four ``torch.device("cpu")`` entries, so a ``devices > 0`` engine gets a
``DeviceExecutor`` over three secondary "cards" whose closures run on
their ``serve-dev*`` threads with the placement named
(``executor.placement()``).  All CPU devices compare equal, so Stage A
uses the engine's own fields there; the replica path is held by the unit
tests at the end, on ``torch.device("cpu", 1)``, a device that compares
unequal to the engine's ``cpu`` and makes tensors on the CPU.

Held, as the reference holds them: (a) bit-identity against the
``SyncExecutor`` for devices {1, 2, 4} x prefetch {0, 2}; (b) commit order
under a slow first probe; (c) placement round-robin on the secondary
devices, never the engine thread; (d) the one-device fallback; (e)
tracing on and off; (f) two replicas over one ``ShardedSceneCache``.
Then the port's devices=2, prefetch=2 engine against the JAX engine
(sync, one CPU device) on the same requests, at
``tests/test_torch_render_serve.py``'s tolerance.
"""
import dataclasses
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import params as tparams
from repro_torch.core import fields, model, pipeline, scene
from repro_torch.framecache import probe as fc_probe
from repro_torch.kernels import ops
from repro_torch.obs import TraceConfig
from repro_torch.scenecache import SceneCacheConfig, ShardedSceneCache
from repro_torch.serve import admission
from repro_torch.serve import executor as executor_lib
from repro_torch.serve.render_engine import (RenderRequest, RenderServeConfig,
                                             RenderServingEngine)
from repro_torch.serve.stats import DETERMINISTIC_COUNTERS
from test_torch_lm_train import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import check_trace  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread", "four_devices")

CPU = torch.device("cpu")
OTHER = torch.device("cpu", 1)     # unequal to CPU, its tensors on the CPU
ACFG = dict(ns_full=48, probe_stride=4, candidates=(8, 16, 32),
            block_size=64, chunk=16, sort_by_opacity=False)
SIZE = 16
RTOL, ATOL = 1e-4, 1e-5
STAT_KEYS = ("probe_reused", "probe_skipped", "radiance_reused",
             "rays_marched", "rays_total", "samples_processed",
             "samples_reused", "probe_samples", "scene_block_hits")


@pytest.fixture
def four_devices(monkeypatch):
    monkeypatch.setattr(executor_lib, "_available_devices",
                        lambda: [CPU] * 4)


@pytest.fixture(scope="module")
def flds():
    return {"mic": fields.analytic_field_fns(scene.make_scene("mic"))}


def cam_at(sc, theta, phi=0.5):
    return sc.look_at_camera(SIZE, SIZE, theta=theta, phi=phi)


def serve_cfg(devices=0, prefetch=2, slots=2, cfg=None):
    """The reference test's configuration, of the port's (or ``cfg``'s)
    config classes."""
    if cfg is None:
        from repro_torch import framecache as fc
        from repro_torch.serve import render_engine as cfg
    else:
        from repro import framecache as fc
    return cfg.RenderServeConfig(
        slots=slots, blocks_per_batch=4,
        reuse=fc.ProbeReuseConfig(refresh_every=0),
        radiance=fc.RadianceReuseConfig(refresh_every=0),
        prefetch=prefetch, devices=devices)


def replay_traj(n=8, offset=0, sc=scene, req=RenderRequest):
    # poses repeat every 3 requests: laps 2+ exercise warp reuse, full
    # radiance hits, AND speculation racing the in-flight sources
    return [req(rid=offset + i, scene="mic",
                cam=cam_at(sc, 0.7 + 0.05 * (i % 3)))
            for i in range(n)]


def engine(flds, rcfg, **kw):
    return RenderServingEngine(flds, pipeline.ASDRConfig(**ACFG), rcfg,
                               device="cpu", **kw)


def serve(flds, rcfg, reqs, **kw):
    """({rid: request}, finish order, engine_stats, executor) of one
    engine serving ``reqs``."""
    eng = engine(flds, rcfg, **kw)
    try:
        done = eng.render(reqs)
        return ({r.rid: r for r in done}, [r.rid for r in done],
                eng.engine_stats(), eng.executor)
    finally:
        eng.close()


def assert_same(ref, got, st_ref, st, what=""):
    assert ref.keys() == got.keys()
    for rid in ref:
        np.testing.assert_array_equal(ref[rid].image, got[rid].image,
                                      err_msg=f"frame {rid} {what}")
    for c in DETERMINISTIC_COUNTERS:
        assert st_ref[c] == st[c], (what, c, st_ref[c], st[c])


@pytest.fixture(scope="module")
def sync_run(flds):
    """The synchronous single-device run every placement is held to."""
    done, order, st, _ = serve(flds, serve_cfg(0, 0), replay_traj())
    return done, order, st


# ----------------------------------------------------------- determinism
@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("devices", [1, 2, 4])
def test_device_executor_bit_identity(flds, sync_run, devices, prefetch):
    """(a) Placement moves WHERE Stage A runs, never WHAT commits: frames
    and the deterministic counters equal the synchronous run's;
    devices=4 clamps to the 3 secondary devices."""
    ref, _, st_ref = sync_run
    done, _, st, ex = serve(flds, serve_cfg(devices, prefetch),
                            replay_traj())
    assert isinstance(ex, executor_lib.DeviceExecutor)
    assert len(ex.devices) == min(devices, 3) and ex.device == CPU
    assert_same(ref, done, st_ref, st, f"devices={devices}, "
                f"prefetch={prefetch}")


def test_commit_ordering_under_adversarial_slow_device(flds, monkeypatch):
    """(b) Commits happen on the engine thread in ADMISSION order even
    when the earliest-submitted probes finish last: finish order, frames
    and counters equal the synchronous run's."""
    real_execute = fc_probe.execute_probe_plan
    lock = threading.Lock()
    seen = {"n": 0}

    def slow_execute(fns, acfg, cam, plan, probe_jitter=None, rcfg=None,
                     device=None):
        with lock:
            i = seen["n"]
            seen["n"] += 1
        if plan.kind in ("fresh", "refresh"):
            time.sleep(0.12 if i < 2 else 0.0)   # earliest probes slowest
        return real_execute(fns, acfg, cam, plan, probe_jitter, rcfg=rcfg,
                            device=device)

    def traj():
        return [RenderRequest(rid=i, scene="mic",
                              cam=cam_at(scene, 0.55 + 0.1 * i))
                for i in range(6)]

    from repro_torch import framecache as fc
    cfg = RenderServeConfig(
        slots=1, blocks_per_batch=4,
        reuse=fc.ProbeReuseConfig(max_angle_deg=0.01, max_translation=1e-4),
        radiance=None, prefetch=4, devices=0)
    done_s, order_s, st_s, _ = serve(flds, cfg, traj())
    monkeypatch.setattr(fc_probe, "execute_probe_plan", slow_execute)
    done_d, order_d, st_d, ex = serve(flds, dataclasses.replace(
        cfg, devices=4), traj())
    assert isinstance(ex, executor_lib.DeviceExecutor)
    assert seen["n"] >= 6 and order_d == order_s
    assert_same(done_s, done_d, st_s, st_d, "slow first probes")


# -------------------------------------------------------------- placement
def test_stage_a_lands_on_secondary_devices():
    """(c) The placement rule itself: submissions round-robin over the
    secondary devices' queues (``serve-dev0`` ..), each closure sees its
    placement device, the engine thread never runs one and is never
    placed, and every result is taken on the engine thread."""
    ex = executor_lib.DeviceExecutor(device=CPU)
    assert ex.devices == [CPU] * 3
    n = 2 * len(ex.devices)
    ran = threading.Semaphore(0)

    def job(i):
        out = (executor_lib.placement(), threading.current_thread().name,
               torch.full((4,), 3.0) * 2.0 + i)
        ran.release()
        return out

    for i in range(n):
        ex.submit(i, lambda i=i: job(i))
    for _ in range(n):             # all ran on their queues: none stolen
        assert ran.acquire(timeout=30)
    placed = [ex.take(i) for i in range(n)]
    ex.close()
    lanes = [name.rsplit("_", 1)[0] for _, name, _ in placed]
    assert lanes == [f"serve-dev{i}" for i in range(3)] * 2, lanes
    assert all(dev == CPU for dev, _, _ in placed)
    assert executor_lib.placement() is None
    for i, (_, _, out) in enumerate(placed):
        np.testing.assert_array_equal(out.numpy(), np.full((4,), 6.0 + i))


def test_engine_stage_a_reads_its_placement(flds, monkeypatch):
    """(c) Through the engine: each probe runs with the device its thread
    was placed on (on a ``serve-dev0`` / ``serve-dev1`` queue), or unplaced
    on the engine's device when the engine prepares it itself."""
    real_execute = fc_probe.execute_probe_plan
    calls = []

    def recording(fns, acfg, cam, plan, probe_jitter=None, rcfg=None,
                  device=None):
        calls.append((threading.current_thread().name,
                      executor_lib.placement(), device))
        return real_execute(fns, acfg, cam, plan, probe_jitter, rcfg=rcfg,
                            device=device)

    monkeypatch.setattr(fc_probe, "execute_probe_plan", recording)
    serve(flds, serve_cfg(2, 2), replay_traj())
    placed = [c for c in calls if c[0].startswith("serve-dev")]
    assert placed and {c[0].rsplit("_", 1)[0] for c in placed} <= {
        "serve-dev0", "serve-dev1"}
    assert all(p == CPU and d == CPU for _, p, d in placed)
    assert all(p is None and d == CPU for name, p, d in calls
               if not name.startswith("serve-dev"))


def test_single_device_fallback(flds, monkeypatch):
    """(d) A devices>0 config on a one-device host gives the bit-identical
    SyncExecutor instead of failing."""
    monkeypatch.setattr(executor_lib, "_available_devices", lambda: [CPU])
    assert isinstance(executor_lib.make_executor(0, devices=2),
                      executor_lib.SyncExecutor)
    done, _, _, ex = serve(flds, serve_cfg(devices=2), replay_traj(4))
    assert isinstance(ex, executor_lib.SyncExecutor)
    assert len(done) == 4 and all(r.image is not None
                                  for r in done.values())


# -------------------------------------------------------------------- obs
@pytest.mark.parametrize("prefetch", [0, 2])
def test_device_executor_tracing_bit_identity(flds, tmp_path, prefetch):
    """(e) Frames and counters identical with the tracer on; placement
    spans on the serve-dev* lanes carry their device; the exported trace
    passes tools/check_trace.py."""
    ref, _, st_ref, _ = serve(flds, serve_cfg(2, prefetch), replay_traj())
    path = tmp_path / f"fleet_trace_{prefetch}.json"
    eng = engine(flds, dataclasses.replace(
        serve_cfg(2, prefetch), trace=TraceConfig(path=str(path))))
    assert isinstance(eng.executor, executor_lib.DeviceExecutor)
    done = {r.rid: r for r in eng.render(replay_traj())}
    st = eng.engine_stats()
    spans = list(eng.tracer.spans)
    eng.close()
    assert_same(ref, done, st_ref, st, f"traced, prefetch={prefetch}")
    if prefetch > 0:
        runs = [s for s in spans if s.name == "executor.run"]
        assert runs, "no placement spans with prefetch on"
        assert all(s.lane.startswith("serve-dev") for s in runs)
        assert all(s.attrs["backend"] == "device"
                   and s.attrs["device"] == "cpu" for s in runs)
    assert check_trace.check_file(path) == []


# ------------------------------------------------------------------ fleet
def test_two_replica_fleet_sharded_cache_identity(flds):
    """(f) Two engine replicas (device executors) over one
    ShardedSceneCache replay the same poses: every frame bit-identical
    to a plain sync engine's, cross-replica block hits, every shard
    within its byte budget."""
    ref, _, _, _ = serve(flds, RenderServeConfig(
        slots=2, blocks_per_batch=4, reuse=None, radiance=None),
        replay_traj(6))
    shared = ShardedSceneCache(SceneCacheConfig(byte_budget=8 << 20),
                               shards=4)
    cfg = RenderServeConfig(slots=2, blocks_per_batch=4, reuse=None,
                            radiance=None, devices=2)
    engines = [engine(flds, cfg, scenecache=shared) for _ in range(2)]
    assert all(isinstance(e.executor, executor_lib.DeviceExecutor)
               for e in engines)
    done = [engines[0].render(replay_traj(6)),
            engines[1].render(replay_traj(6, offset=100))]
    for frames in done:
        for r in frames:
            np.testing.assert_array_equal(r.image, ref[r.rid % 100].image)
    assert engines[1].engine_stats()["scene_block_hits"] > 0
    st = shared.stats()
    assert all(b <= st["per_shard_budget"]
               for b in st["per_shard_resident_bytes"])
    for eng in engines:
        eng.close()
    shared.close()


# ------------------------------------------------------- the JAX engine
@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine (sync, one CPU device) on the replay trajectory,
    called once."""
    from repro.core import fields as jfields
    from repro.core import pipeline as jpl
    from repro.core import scene as jsc
    from repro.serve import render_engine as jre

    eng = jre.RenderServingEngine(
        {"mic": jfields.analytic_field_fns(jsc.make_scene("mic"))},
        jpl.ASDRConfig(**ACFG), serve_cfg(0, 2, cfg=jre))
    try:
        done = eng.render(replay_traj(sc=jsc, req=jre.RenderRequest))
        return done, eng.engine_stats()
    finally:
        eng.close()


def test_placed_engine_matches_the_reference(flds, jax_run):
    """The port's devices=2, prefetch=2 engine against the JAX engine on
    the same requests: finish order and per-request counters exact,
    frames within rtol 1e-4 / atol 1e-5, deterministic counters equal."""
    from repro.serve.stats import DETERMINISTIC_COUNTERS as J_COUNTERS
    done_j, st_j = jax_run
    done, order, st, ex = serve(flds, serve_cfg(2, 2), replay_traj())
    assert isinstance(ex, executor_lib.DeviceExecutor)
    assert order == [r.rid for r in done_j]
    for r in done_j:
        got = done[r.rid]
        np.testing.assert_allclose(got.image, np.asarray(r.image),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"request {r.rid}")
        for k in STAT_KEYS:
            assert got.stats[k] == r.stats[k], (r.rid, k)
    assert DETERMINISTIC_COUNTERS == J_COUNTERS
    for c in DETERMINISTIC_COUNTERS:
        assert st[c] == st_j[c], (c, st[c], st_j[c])


# ------------------------------------------------------------- replicas
def small_ngp():
    """A small NGP field on the CPU, random tables scaled so the probe
    spans the ladder."""
    cfg = model.NGPConfig.small()
    return tparams.from_jax_params(tparams.random_params(cfg, 3, 300.0),
                                   cfg, device="cpu")


def test_replica_built_once_per_scene_and_card():
    """``Replicas``: the engine's device gets the fields themselves; each
    (scene, device) pair is rebuilt once and kept; the kernel, plain and
    analytic fields' replicas compute bit for bit what they do; a
    FieldFns without a recipe raises."""
    field = small_ngp()
    flds = {"kernel": ops.field_fns(field), "plain": model.field_fns(field),
            "params": model.param_fns(field.params(), field.cfg),
            "mic": fields.analytic_field_fns(scene.make_scene("mic"))}
    reps = fields.Replicas(flds, CPU)
    for name, fns in flds.items():
        assert reps.on(name, "cpu") is fns
    a = reps.on("kernel", OTHER)
    assert reps.on("kernel", "cpu:1") is a and len(reps.built) == 1
    assert reps.on("kernel", torch.device("cpu", 2)) is not a
    assert reps.on("mic", OTHER) is flds["mic"]   # built on points' device
    assert isinstance(a.fused, ops.FusedMarchResources)
    assert a.fused is not flds["kernel"].fused
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-0.1, 1.1, (300, 3)).astype(
        np.float32))
    dirs = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((300, 3)).astype(np.float32)), dim=-1)
    for name in ("kernel", "plain", "params"):
        fns, rep = flds[name], reps.on(name, OTHER)
        (s0, g0), (s1, g1) = fns.density(pts), rep.density(pts)
        assert torch.equal(s0, s1) and torch.equal(g0, g1), name
        assert torch.equal(fns.color(g0, dirs), rep.color(g1, dirs)), name
    assert len(reps.built) == 5
    bare = fields.FieldFns(density=lambda p: flds["mic"].density(p),
                           color=flds["mic"].color)
    with pytest.raises(ValueError, match="recipe"):
        fields.Replicas({"bare": bare}, CPU).on("bare", OTHER)


def placed_prepare(eng, req, device=OTHER):
    """``admission.prepare`` run by a DeviceExecutor placed on
    ``device``, taken back on the engine thread."""
    ex = executor_lib.DeviceExecutor([device], device=eng.device)
    try:
        ex.submit("k", lambda: admission.prepare(eng, req))
        return ex.take("k")
    finally:
        ex.close()


def test_prepare_reads_the_placement_device(monkeypatch):
    """Placed on ``cpu:1``, ``prepare`` probes with that device and the
    kernel field's replica there, and its speculation equals the engine's
    own; a placement whose replica cannot be built raises from ``take``
    instead of running on the engine's device."""
    real_execute = fc_probe.execute_probe_plan
    seen = []

    def recording(fns, acfg, cam, plan, probe_jitter=None, rcfg=None,
                  device=None):
        seen.append((fns, device))
        return real_execute(fns, acfg, cam, plan, probe_jitter, rcfg=rcfg,
                            device=device)

    monkeypatch.setattr(fc_probe, "execute_probe_plan", recording)
    eng = engine({"ngp": ops.field_fns(small_ngp())}, RenderServeConfig(
        slots=1, blocks_per_batch=4, reuse=None, probe_seed=5))
    req = RenderRequest(rid=0, scene="ngp", cam=cam_at(scene, 0.7))
    placed = placed_prepare(eng, req)
    inline = admission.prepare(eng, req)
    (fns_p, dev_p), (fns_i, dev_i) = seen
    assert dev_p == OTHER and fns_p is eng.replicas.on("ngp", OTHER)
    assert fns_p is not eng.fields["ngp"]
    assert dev_i == CPU and fns_i is eng.fields["ngp"]
    for got, want in zip(placed.tensors(), inline.tensors()):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(placed.layout.order, inline.layout.order)
    np.testing.assert_array_equal(placed.layout.budgets,
                                  inline.layout.budgets)
    eng.close()

    bare = fields.FieldFns(density=lambda p: (p[:, 0], p),
                           color=lambda g, d: g)
    eng = engine({"bare": bare}, RenderServeConfig(reuse=None))
    with pytest.raises(ValueError, match="recipe"):
        placed_prepare(eng, RenderRequest(rid=0, scene="bare",
                                          cam=cam_at(scene, 0.7)))
    eng.close()


def test_prepared_moves_to_the_engine_device():
    """``Prepared.to_device``: itself where every tensor lies on the
    device; else each tensor Stage B and the pool read (both layouts'
    rays, the probe maps, the radiance plan's warp) moved, the host
    arrays and plans kept."""
    from repro_torch import framecache as fc
    eng = engine(
        {"mic": fields.analytic_field_fns(scene.make_scene("mic"))},
        RenderServeConfig(slots=1, blocks_per_batch=4,
                          reuse=fc.ProbeReuseConfig(refresh_every=0),
                          radiance=fc.RadianceReuseConfig(refresh_every=0),
                          density_refresh=True))
    # at 24 x 24 the second pose's warp leaves rays to march
    cams = [scene.look_at_camera(24, 24, theta=t, phi=0.5)
            for t in (0.7, 0.73)]
    eng.render([RenderRequest(rid=0, scene="mic", cam=cams[0])])
    prep = admission.prepare(eng, RenderRequest(rid=1, scene="mic",
                                                cam=cams[1]))
    assert prep.rplan.warped is not None and prep.dens_layout is not None
    assert prep.to_device(CPU) is prep
    assert executor_lib._handover(prep, None, CPU) is prep
    meta = torch.device("meta")
    moved = prep.to_device(meta)
    assert len(moved.tensors()) == len(prep.tensors()) == 9
    assert all(t.device == meta for t in moved.tensors())
    assert moved.layout.order is prep.layout.order
    assert moved.rplan.basis == prep.rplan.basis
    assert moved.maps.cost == prep.maps.cost
    assert all(t.device == CPU for t in prep.tensors())
    eng.close()
