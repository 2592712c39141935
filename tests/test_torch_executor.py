"""Port parity and properties: the Stage-A executors (serve/executor.py)
and the admission/pool split they run.

Frames and deterministic counters equal across workers {0, 2} x prefetch
{0, 2}, and equal to the JAX engine's; commits in admission order under
a slow probe that inverts worker completion; no pad/sort inside the
Stage-B commit; untorn plan snapshots under concurrent rebases; the
executor contract (steal and leak checks) for all three backends; the
one-device rule of ``make_executor``; the facade's size budget; and
launch counts that lose no increment across threads.
"""
import dataclasses
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import pipeline as tpl
from repro_torch.framecache import probe as fc_probe
from repro_torch.kernels import _build, ops
from repro_torch.kernels import hash_encode as HE
from repro_torch.serve import admission, executor as executor_lib
from repro_torch.serve import pool as pool_lib
from repro_torch.serve import render_engine as tre
from repro_torch.serve.stats import DETERMINISTIC_COUNTERS
from test_torch_render_serve import (acfgs, assert_parity, field_pairs,
                                     requests, run_both, run_port)

ROOT = Path(__file__).resolve().parents[1]
REPLAY = dict(slots=2, blocks_per_batch=4, reuse=dict(refresh_every=0),
              radiance=dict(refresh_every=0))


def replay_spec(n=8):
    # poses repeat every 3 requests: laps 2+ exercise warp reuse, full
    # radiance hits, AND speculation racing the in-flight sources
    return [(i, "mic", 0.7 + 0.05 * (i % 3), 0.5) for i in range(n)]


def port_engine(rcfg, scenes=("mic",)):
    flds = field_pairs()
    return tre.RenderServingEngine({s: flds[s][1] for s in scenes},
                                   acfgs()[1], rcfg, device="cpu")


# ----------------------------------------------------------- determinism
def test_workers_determinism():
    """Executors move WHERE Stage A runs, never WHAT commits: frames and
    commit-determined counters are bit-identical for workers {0, 2} x
    prefetch {0, 2}, and so equal to the JAX engine's synchronous run."""
    done_j, done_t, st_j, st_t = run_both(replay_spec(), workers=0,
                                          prefetch=0, **REPLAY)
    assert_parity(done_j, done_t, st_j, st_t)
    runs = {(0, 0): ({r.rid: r for r in done_t}, st_t)}
    for workers, prefetch in ((0, 2), (2, 0), (2, 2)):
        done, st = run_port(replay_spec(), workers=workers,
                            prefetch=prefetch, **REPLAY)
        runs[(workers, prefetch)] = ({r.rid: r for r in done}, st)
    ref_done, ref_st = runs[(0, 0)]
    for key, (done, st) in runs.items():
        for rid in ref_done:
            np.testing.assert_array_equal(ref_done[rid].image,
                                          done[rid].image, err_msg=str(key))
        for c in DETERMINISTIC_COUNTERS:
            assert ref_st[c] == st[c], (key, c)
    assert ref_st["misprepares"] == 0


def test_commit_ordering_under_adversarial_slow_probe(monkeypatch):
    """Commits happen on the engine thread in ADMISSION order even when
    worker completion order is inverted: the earliest-submitted probes are
    stubbed slowest — finish order, frames and counters still match the
    synchronous run."""
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
        return requests([(i, "mic", 0.55 + 0.1 * i, 0.5)
                         for i in range(6)])[1]

    cfg = tre.RenderServeConfig(
        slots=1, blocks_per_batch=4,
        reuse=fc_probe.ProbeReuseConfig(max_angle_deg=0.01,
                                        max_translation=1e-4),
        radiance=None, prefetch=4, workers=0)
    eng_s = port_engine(cfg)
    done_s = eng_s.render(traj())

    monkeypatch.setattr(fc_probe, "execute_probe_plan", slow_execute)
    eng_t = port_engine(dataclasses.replace(cfg, workers=4))
    done_t = eng_t.render(traj())
    eng_t.close()

    assert seen["n"] >= 6
    assert [r.rid for r in done_t] == [r.rid for r in done_s]
    by_rid = {r.rid: r for r in done_s}
    for r in done_t:
        np.testing.assert_array_equal(r.image, by_rid[r.rid].image)
    st_s, st_t = eng_s.engine_stats(), eng_t.engine_stats()
    for c in DETERMINISTIC_COUNTERS:
        assert st_s[c] == st_t[c], (c, st_s[c], st_t[c])


# ------------------------------------------------- Stage-B instrumentation
def test_stage_b_commit_performs_no_pad_sort(monkeypatch):
    """pad/sort (and layout building generally) is Stage-A work — it never
    executes inside the commit section, at any prefetch depth."""
    calls = {"pad": 0, "sort": 0, "layout": 0, "in_commit": 0}

    def counted(name, real):
        def fn(*a, **kw):
            calls[name] += 1
            calls["in_commit"] += admission.commit_active()
            return real(*a, **kw)
        return fn

    monkeypatch.setattr(tpl, "pad_rays_to_blocks",
                        counted("pad", tpl.pad_rays_to_blocks))
    monkeypatch.setattr(tpl, "block_sort", counted("sort", tpl.block_sort))
    monkeypatch.setattr(pool_lib, "build_layout",
                        counted("layout", pool_lib.build_layout))
    from test_torch_render_serve import serve_cfgs
    for prefetch in (0, 2):
        eng = port_engine(serve_cfgs(prefetch=prefetch, **REPLAY)[1])
        eng.render(requests(replay_spec(6))[1])
        eng.close()
    assert calls["pad"] > 0 and calls["sort"] > 0 and calls["layout"] > 0
    assert calls["in_commit"] == 0, calls


# ----------------------------------------------------- snapshot integrity
def test_plan_snapshot_never_torn_under_concurrent_rebase():
    """A plan's entry snapshot (maps + version) is internally consistent
    while the engine thread rebases the entry: generation g writes g into
    every map, so a torn snapshot would mix generations."""
    _, acfg = acfgs()
    cache = fc_probe.ProbeCache(fc_probe.ProbeReuseConfig(refresh_every=0))
    cam = requests([(0, "mic", 0.7, 0.5)])[1][0].cam

    def maps_of(gen):
        return fc_probe.ProbeMaps(torch.full((4,), gen, dtype=torch.int32),
                                  torch.full((4,), float(gen)),
                                  torch.full((4,), float(gen)), 0)

    with cache.lock:
        cache._store(cam, acfg, maps_of(0))
    entry = cache._entries[0]
    stop = threading.Event()
    torn = []

    def reader():
        while not stop.is_set():
            plan = fc_probe.plan_probe(cache, cam, acfg)
            if plan.kind != "reuse":
                continue
            m = plan.src_maps
            gens = {int(m.counts[0]), int(m.opacity[0]), int(m.depth[0])}
            if len(gens) != 1:
                torn.append(gens)
            if plan.basis[2] != int(m.counts[0]):
                torn.append(("version", plan.basis[2], int(m.counts[0])))

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    for gen in range(1, 300):
        fc_probe.commit_probe_plan(cache, cam, acfg,
                                   fc_probe.ProbePlan("refresh", entry),
                                   maps_of(gen))
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not torn, f"observed torn entry snapshots: {torn[:5]}"
    assert entry.version == 299


# ------------------------------------------------------------- unit tests
EXECUTOR_FACTORIES = {
    "sync": lambda: executor_lib.SyncExecutor(),
    "threaded": lambda: executor_lib.ThreadedExecutor(2, device="cpu"),
    "device": lambda: executor_lib.DeviceExecutor(devices=["cpu"]),
}


@pytest.mark.parametrize("kind", sorted(EXECUTOR_FACTORIES))
def test_executor_contract(kind):
    """Identical across all backends: idempotent submit per key; blocking
    take; take of an unknown key is None; every submitted key drains
    through take (no leaks); reset and close are idempotent; submit after
    close raises."""
    ex = EXECUTOR_FACTORIES[kind]()
    ran = []
    ex.submit("a", lambda: ran.append(1) or "r1")
    ex.submit("a", lambda: ran.append(2) or "r2")     # idempotent
    assert ex.take("a") == "r1"
    assert ran == [1]
    assert ex.take("a") is None                       # taken once
    assert ex.take("never") is None
    ex.submit("k", lambda: time.sleep(0.05) or "slow")
    assert ex.take("k") == "slow"                     # blocks until done

    keys = [f"key{i}" for i in range(5)]
    for k in keys:
        ex.submit(k, lambda k=k: f"v-{k}")
    assert ex.pending() == len(keys)
    assert [ex.take(k) for k in keys] == [f"v-{k}" for k in keys]
    assert ex.pending() == 0

    ex.submit("r", lambda: "gone")
    ex.reset()
    ex.reset()
    assert ex.pending() == 0 and ex.take("r") is None

    ex.close()
    ex.close()
    with pytest.raises(RuntimeError):
        ex.submit("late", lambda: "x")
    assert ex.take("late") is None


def test_take_steals_queued_speculation():
    """The engine never blocks on speculation still QUEUED behind a busy
    worker — take() cancels the unstarted future and runs the closure
    inline."""
    ex = executor_lib.ThreadedExecutor(1, max_concurrent=1, device="cpu")
    ex.submit("slow", lambda: time.sleep(2.0) or "slow")
    ex.submit("fast", lambda: "fast")
    t0 = time.time()
    assert ex.take("fast") == "fast"
    assert time.time() - t0 < 1.0, "take() waited behind queued work"
    ex.close()


def test_make_executor_one_device_rule(monkeypatch):
    """devices>0 on a host without a second card gives the SyncExecutor
    (which runs on the engine's card); with secondary devices, a
    DeviceExecutor over them; workers>0 a ThreadedExecutor on the
    engine's device."""
    ex = executor_lib.make_executor(0, devices=2)
    assert isinstance(ex, executor_lib.SyncExecutor)
    ex.close()
    monkeypatch.setattr(executor_lib, "_available_devices",
                        lambda: [torch.device("cpu")])
    assert isinstance(executor_lib.make_executor(0, devices=2),
                      executor_lib.SyncExecutor)
    monkeypatch.setattr(executor_lib, "_available_devices",
                        lambda: [torch.device("cpu")] * 3)
    ex = executor_lib.make_executor(2, devices=1)
    assert isinstance(ex, executor_lib.DeviceExecutor) and ex.workers == 1
    ex.close()
    ex = executor_lib.make_executor(2, device="cpu")
    assert isinstance(ex, executor_lib.ThreadedExecutor)
    assert ex.workers == 2 and ex.device == torch.device("cpu")
    assert ex._stream() is None                    # no stream off the card
    ex.close()
    assert isinstance(executor_lib.make_executor(0),
                      executor_lib.SyncExecutor)
    with pytest.raises(ValueError):
        executor_lib.ThreadedExecutor(0)


def test_prepared_tensors_and_wait():
    """A speculation lists the tensors it produced (what a worker hands to
    the engine's stream) and waits on them; on the CPU both are
    pass-throughs."""
    eng = port_engine(tre.RenderServeConfig(slots=1, blocks_per_batch=4,
                                            reuse=None))
    req = requests([(0, "mic", 0.7, 0.5)])[1][0]
    prep = admission.prepare(eng, req)
    ts = prep.tensors()
    assert ts[0] is prep.layout.rays[0] and ts[1] is prep.layout.rays[1]
    assert prep.maps.counts in [t for t in ts if t is prep.maps.counts]
    prep.block_until_ready()
    assert executor_lib._handover(prep, None) is prep
    executor_lib.block_until_ready(None, np.zeros(2), *ts)
    eng.close()


def test_render_engine_facade_size_budget():
    """The facade stays a thin scheduling loop: render_engine.py within
    250 lines and the scheduler within 330, as the reference's own."""
    limits = {"src/repro_torch/serve/render_engine.py": 250,
              "src/repro_torch/serve/scheduler.py": 330}
    for rel, limit in limits.items():
        n = len((ROOT / rel).read_text().splitlines())
        assert n <= limit, f"{rel}: {n} lines > {limit}"


def test_launch_counts_lose_nothing_across_threads():
    """Kernel wrappers count a launch under one lock (a count waits while
    it is held): 8 threads counting at once lose no increment, and a wrapper's plain version (CPU
    tensors) counts nothing whatever the thread."""
    ops.reset_launch_counts()
    # a count waits for the lock that reset_launch_counts and
    # launch_counts take too
    with _build.launch_lock:
        waiter = threading.Thread(target=_build.count_launch,
                                  args=(HE.hash_encode,))
        waiter.start()
        waiter.join(timeout=0.2)
        assert waiter.is_alive() and HE.hash_encode.launches == 0
    waiter.join(timeout=10)
    assert not waiter.is_alive()
    assert ops.launch_counts()["hash_encode"] == 1
    ops.reset_launch_counts()
    n_threads, per = 8, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        start = threading.Barrier(n_threads)

        def hammer():
            start.wait()
            for _ in range(per):
                _build.count_launch(HE.hash_encode)

        field = field_pairs()["ngp_field"]

        def plain():
            start.wait()
            pts = torch.rand((64, 3))
            for _ in range(3):
                ops.hash_encode(pts, field.grid, field.cfg.grid)

        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert ops.launch_counts()["hash_encode"] == n_threads * per
        ops.reset_launch_counts()
        threads = [threading.Thread(target=plain) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert ops.launch_counts()["hash_encode"] == 0
    finally:
        sys.setswitchinterval(old)
        ops.reset_launch_counts()
