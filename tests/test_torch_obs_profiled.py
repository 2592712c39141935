"""The port's tracing beyond the reference's: spans record under
``torch.profiler`` with no tracer installed (``obs.trace.profiled``), the
exports share the profiler's Unix clock, the frame's phase spans, the
server's host spans and Stage-A placement counters, and the benchmark's
readers of those spans (``bench/metrics``).
"""
import importlib.util
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs as tobs
from repro_torch.core import fields as tfields
from repro_torch.core import pipeline as tpl
from repro_torch.core import scene as tsc
from repro_torch.obs import trace as ttrace
from repro_torch.scenecache import SceneCacheConfig
from repro_torch.serve import render_engine as tre
from repro_torch.serve.executor import STAGE_A

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import check_trace  # noqa: E402

ACFG = dict(ns_full=48, probe_stride=4, candidates=(8, 16, 32), block_size=64,
            chunk=16)
SIZE = 24
CPU = [ProfilerActivity.CPU]
FRAME_PHASES = ["frame.probe", "frame.interpolate", "frame.sort",
                "frame.march", "frame.unsort"]
ENGINE_PHASES = {"admission.wait", "pool.add_slot", "pool.sweep",
                 "pool.dispatch_round", "pool.collect", "slot.finalize",
                 "executor.submit"}


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    assert tobs.active() is None
    yield
    assert tobs.active() is None


def _field():
    return tfields.analytic_field_fns(tsc.make_scene("mic"))


def _cam(theta=0.7, phi=0.5):
    return tsc.look_at_camera(SIZE, SIZE, theta=theta, phi=phi)


# ------------------------------------------------------- profiled window
def test_span_records_only_under_the_profiler():
    """No tracer, no profiler: the shared NULL_SPAN.  Under the profiler
    the spans record into ``profiled()``; a second session is a fresh
    window; afterwards span() is NULL_SPAN again."""
    assert tobs.span("probe.plan") is tobs.NULL_SPAN
    with profile(activities=CPU):
        with tobs.span("outer", k=1):
            with tobs.span("inner"):
                tobs.instant("mark")
    first = tobs.profiled()
    assert [s.name for s in first.spans] == ["mark", "inner", "outer"]
    by = {s.name: s for s in first.spans}
    assert by["inner"].parent == by["outer"].sid
    assert by["outer"].attrs == {"k": 1}
    assert tobs.span("probe.plan") is tobs.NULL_SPAN
    with profile(activities=CPU):
        with tobs.span("again"):
            pass
    second = tobs.profiled()
    assert second is not first
    assert [s.name for s in second.spans] == ["again"]
    assert [s.name for s in first.spans] == ["mark", "inner", "outer"]


def test_installed_tracer_takes_precedence_over_the_profiler():
    tr = tobs.Tracer()
    tobs.install(tr)
    try:
        with profile(activities=CPU):
            with tobs.span("mine"):
                pass
    finally:
        tobs.uninstall(tr)
    tr.drain()
    assert [s.name for s in tr.spans] == ["mine"]
    window = tobs.profiled()
    assert window is None or "mine" not in {s.name for s in window.spans}


def test_device_flag_is_not_an_attribute_and_cpu_spans_carry_no_device_ms():
    tr = tobs.Tracer()
    tobs.install(tr)
    try:
        with tobs.span("a", device=True):
            pass
        with tobs.span("b", device=False, shard=1):
            pass
        with tobs.span("c", device="cpu"):
            pass
    finally:
        tobs.uninstall(tr)
    tr.drain()
    assert [s.attrs for s in tr.spans] == [{}, {"shard": 1},
                                           {"device": "cpu"}]


# ------------------------------------------------------------- one clock
def _profiler_range(prof, name):
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == name]
    return ev.start_ns() / 1e3, (ev.start_ns() + ev.duration_ns()) / 1e3


def test_export_is_on_the_profilers_clock(tmp_path):
    """A ``record_function`` range opened inside a span lies within the
    span's exported [ts, ts + dur] within 50 us, in the program's export
    and in its merge with the profiler's own export; the export passes
    ``tools/check_trace.py`` with Unix-clock ts."""
    with profile(activities=CPU) as prof:
        with tobs.span("host.work"):
            time.sleep(1e-3)
            with record_function("inner.range"):
                torch.ones(64).sum()
            time.sleep(1e-3)
    tr = tobs.profiled()
    path = tobs.export.write_chrome_trace(tmp_path / "t.json", tr.spans,
                                          t_origin=tr.export_origin())
    assert check_trace.check_file(path) == []
    (ev,) = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("name") == "host.work"]
    assert abs(ev["ts"] / 1e6 - time.time()) < 60.0
    lo, hi = _profiler_range(prof, "inner.range")
    assert ev["ts"] - 50.0 <= lo and hi <= ev["ts"] + ev["dur"] + 50.0
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    merged = tobs.export.merge_chrome_traces([path, tmp_path / "prof.json"])
    (rng,) = [e for e in merged["traceEvents"]
              if e.get("name") == "inner.range"]
    assert ev["ts"] - 50.0 <= rng["ts"]
    assert rng["ts"] + rng["dur"] <= ev["ts"] + ev["dur"] + 50.0


def test_merge_moves_a_profiler_export_onto_the_unix_clock():
    """A profiler export counts ts from ``baseTimeNanoseconds`` and names
    every device the build knows: the merge moves its events onto the
    Unix clock and leaves out the rows of devices with no events, so the
    program's default pid 1 does not collide with an idle "GPU 1"."""
    prog = tobs.export.chrome_trace(
        [tobs.Span("pool.collect", 1, 0, "MainThread", 10.0, 10.5, {})],
        t_origin=-1.7e9)
    base_ns = 1_700_000_000_000_000_000
    prof = {"baseTimeNanoseconds": base_ns, "traceEvents": [
        {"ph": "M", "name": "process_labels", "pid": p, "tid": 0,
         "args": {"labels": f"GPU {p}"}} for p in (0, 1)] + [
        {"ph": "X", "name": "fused_march_kernel", "pid": 0, "tid": 7,
         "ts": 10.1e6, "dur": 3e5}]}
    merged = tobs.export.merge_chrome_traces([prog, prof])
    (k,) = [e for e in merged["traceEvents"]
            if e["name"] == "fused_march_kernel"]
    (sp,) = [e for e in merged["traceEvents"] if e["name"] == "pool.collect"]
    assert k["ts"] == pytest.approx(base_ns / 1e3 + 10.1e6)
    assert sp["ts"] <= k["ts"] and k["ts"] + k["dur"] <= sp["ts"] + sp["dur"]
    assert [e["args"]["labels"] for e in merged["traceEvents"]
            if e["name"] == "process_labels"] == ["GPU 0"]
    assert merged["otherData"]["replicas"] == [1]
    prof["traceEvents"].append({"ph": "X", "name": "copy", "pid": 1,
                                "tid": 7, "ts": 0.0, "dur": 1.0})
    with pytest.raises(ValueError):
        tobs.export.merge_chrome_traces([prog, prof])


# ------------------------------------------------------------- the frame
def test_frame_phase_spans_in_order_and_frame_bit_identical():
    fns, acfg = _field(), tpl.ASDRConfig(**ACFG)
    img0, st0 = tpl.render_asdr_image(fns, acfg, _cam(), device="cpu")
    with profile(activities=CPU):
        img1, st1 = tpl.render_asdr_image(fns, acfg, _cam(), device="cpu")
    spans = tobs.profiled().spans
    frame = [s for s in spans if s.name == "frame"]
    assert len(frame) == 1 and frame[0].attrs == {"pixels": SIZE * SIZE}
    kids = sorted((s for s in spans if s.parent == frame[0].sid),
                  key=lambda s: s.t0)
    assert [s.name for s in kids] == FRAME_PHASES
    assert all("device_ms" not in s.attrs for s in spans)
    assert torch.equal(img0, img1)
    assert st0.keys() == st1.keys()
    for k in st0:
        a, b = st0[k], st1[k]
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_render_adaptive_and_probe_phase_match_the_frame():
    """The frame's phases and the public Phase-I / Phase-II entry points
    compute the same counts, budgets and image."""
    fns, acfg = _field(), tpl.ASDRConfig(**ACFG)
    cam = _cam(0.9, 0.6)
    img, st = tpl.render_asdr_image(fns, acfg, cam, device="cpu")
    counts, cost = tpl.probe_phase(fns, acfg, cam, device="cpu")
    assert torch.equal(counts, st["counts"]) and cost == st["probe_samples"]
    o, d = tsc.camera_rays(cam, device="cpu")
    o, d, c, _, _ = tpl.pad_rays_to_blocks(acfg, o, d, counts)
    rgb, _, st2 = tpl.render_adaptive(fns, acfg, o, d, c)
    assert torch.equal(rgb[:SIZE * SIZE].reshape(SIZE, SIZE, 3), img)
    assert torch.equal(st2["budgets"], st["budgets"])


# ------------------------------------------------------------ the server
def _engine_run(workers: int, n: int = 12):
    """A warm ``render()`` call of ``n`` requests (it starts the workers,
    as the benchmark's warm round does), then one under the profiler:
    that call's requests, its spans, the change of the engine's stats
    over it and its wall time."""
    rcfg = tre.RenderServeConfig(
        slots=2, blocks_per_batch=8, prefetch=2, workers=workers,
        scenecache=SceneCacheConfig(byte_budget=4 << 20))
    eng = tre.RenderServingEngine({"mic": _field()}, tpl.ASDRConfig(**ACFG),
                                  rcfg, device="cpu")

    def reqs(first):
        return [tre.RenderRequest(rid=first + i, scene="mic",
                                  cam=_cam(0.7 + 0.05 * i, 0.5))
                for i in range(n)]
    try:
        eng.render(reqs(0))
        before = eng.engine_stats()
        with profile(activities=CPU):
            t0 = time.perf_counter()
            done = eng.render(reqs(n))
            wall = time.perf_counter() - t0
        after = eng.engine_stats()
    finally:
        eng.close()
    delta = {k: after[k] - before[k] for k in after
             if isinstance(after[k], int)}
    return done, delta, tobs.profiled().spans, wall


@pytest.mark.parametrize("workers", [0, 2])
def test_engine_stage_a_tallies_and_host_spans(workers):
    """``admission.wait``'s ``stage_a`` tallies equal the engine's
    placement counters and sum to ``admissions``; ``pool.collect``
    budgets and chunks count ``blocks_marched``, and its stores carry
    ``examined``; the engine lane's top-level spans are the named phases
    and, with Stage A on the engine thread, cover at least 90 % of
    ``render()``.  (With CPU workers the
    engine thread also waits for the interpreter lock between spans;
    the card's run measures that case, PERF.md.)"""
    done, st, spans, wall = _engine_run(workers)
    assert len(done) == 12
    waits = [s.attrs["stage_a"] for s in spans if s.name == "admission.wait"]
    assert {h: waits.count(h) for h in STAGE_A} == {
        h: st[f"stage_a_{h}"] for h in STAGE_A}
    assert len(waits) == st["admissions"] == 12
    assert st["stage_a_inline"] >= 2      # the first slots are never speculated
    collects = [s.attrs for s in spans if s.name == "pool.collect"]
    assert sum(len(c["budgets"]) for c in collects) == st["blocks_marched"]
    assert all(len(c["budgets"]) == len(c["chunks"]) and not c["density"]
               for c in collects)
    by = {s.sid: s for s in spans}
    for name, parent in (("pool.fetch", "pool.collect"),
                         ("scenecache.keys", "pool.add_slot"),
                         ("scenecache.store", "pool.collect")):
        kids = [s for s in spans if s.name == name]
        assert kids and all(by[s.parent].name == parent for s in kids)
    assert all(s.attrs["examined"] == 0 for s in spans
               if s.name == "scenecache.store")   # 4 MiB: nothing evicted
    engine = {s.lane for s in spans if s.name == "pool.dispatch_round"}
    assert len(engine) == 1
    top = [s for s in spans if s.lane in engine and s.parent == 0]
    assert {s.name for s in top} <= ENGINE_PHASES
    if not workers:
        assert sum(s.t1 - s.t0 for s in top) >= 0.9 * wall
    else:
        assert any(s.name == "stage_a.prepare" and s.lane not in engine
                   for s in spans)


def test_take_reports_where_stage_a_ran():
    from repro_torch.serve import executor as ex_lib
    sync = ex_lib.SyncExecutor()
    sync.submit("a", lambda: 1)
    assert sync.take("a") == 1 and sync.last_take == "ready"
    assert sync.take("b") is None and sync.last_take == "inline"
    thr = ex_lib.ThreadedExecutor(1, max_concurrent=1, device="cpu")
    try:
        gate = threading.Event()
        thr.submit("busy", lambda: gate.wait(30) and 2)
        thr.submit("queued", lambda: 3)   # behind the busy worker
        assert thr.take("queued") == 3 and thr.last_take == "stolen"
        gate.set()
        assert thr.take("busy") == 2
        assert thr.last_take in ("ready", "waited")
        assert thr.take("none") is None and thr.last_take == "inline"
    finally:
        thr.close()


# ------------------------------------------------- the benchmark readers
def _reader(name):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _built_spans():
    S = tobs.Span
    return [
        S("pool.dispatch_round", 1, 0, "MainThread", 0.0, 0.010, {}),
        S("stage_a.prepare", 2, 0, "MainThread", 0.010, 0.040, {}),
        S("stage_a.prepare", 3, 0, "serve-stage-a_0", 0.010, 0.110, {}),
        S("admission.wait", 4, 0, "MainThread", 0.0, 0.001,
          {"stage_a": "inline"}),
        S("admission.wait", 5, 0, "MainThread", 0.0, 0.001,
          {"stage_a": "ready"}),
        S("admission.wait", 6, 0, "MainThread", 0.0, 0.001,
          {"stage_a": "stolen"}),
        S("admission.wait", 7, 0, "MainThread", 0.0, 0.001,
          {"stage_a": "waited"}),
        S("scenecache.keys", 8, 0, "MainThread", 1.0, 1.120, {}),
        S("slot.finalize", 9, 0, "MainThread", 2.0, 2.030, {}),
        S("pool.fetch", 10, 0, "MainThread", 3.0, 3.100, {}),
        S("pool.collect", 11, 0, "MainThread", 3.0, 3.2,
          {"budgets": [64, 32], "chunks": [2, 1], "density": False}),
        S("frame.interpolate", 12, 0, "MainThread", 4.0, 4.1,
          {"device_ms": 1.5}),
        S("frame.sort", 13, 0, "MainThread", 4.1, 4.2, {"device_ms": 0.75}),
        S("frame.unsort", 14, 0, "MainThread", 4.2, 4.3,
          {"device_ms": 0.5}),
        S("scenecache.store", 15, 11, "MainThread", 3.1, 3.14,
          {"bytes": 81984, "examined": 2}),
        S("scenecache.store", 16, 11, "MainThread", 3.14, 3.2,
          {"bytes": 81984, "examined": 1}),
    ]


@pytest.mark.parametrize("name,want", [
    ("serve.keys_ms", 60.0), ("serve.finalize_ms", 15.0),
    ("serve.stage_a_engine_ms", 15.0), ("serve.fetch_wait_ms", 50.0),
    ("serve.stage_a_inline_share", 50.0), ("pipeline.interp_ms", 0.75),
    ("pipeline.sort_ms", 0.375), ("pipeline.unsort_ms", 0.25),
    ("serve.store_ms", 50.0)])
def test_span_readers(name, want):
    """Each reader's value on a built span list of two frames, and None
    with no spans (a program without the window, or ``--trace 0``)."""
    read = _reader(name)
    obs = {"frames": 2, "trace": {}}
    assert read(obs, _built_spans()) == pytest.approx(want, rel=1e-9)
    assert read(obs, []) is None


def test_serve_march_roofline_reader():
    """The pooled march's bound from the collect spans' budgets and chunks,
    counted as ``_work`` counts a frame's, over the fused march's device
    time; None without collect spans or without the kernel."""
    read = _reader("serve.march_roofline")
    from bench.metrics import _work
    cfg = json.loads((ROOT / "bench" / "configs" / "ingp-asdr.json")
                     .read_text())
    a = cfg["asdr"]
    samples, anchors = _work.march_samples([64, 32], [2, 1], a["block_size"],
                                           a["chunk"], a["group"])
    assert samples == (64 + 32) * a["block_size"]
    bound = _work.bound_s(*_work.march_cost(cfg, 2, samples, anchors))
    obs = {"frames": 2, "trace": {"kernels": {"fused_march_kernel<2>": 0.5}}}
    assert read(obs, _built_spans(), cfg) == pytest.approx(
        100.0 * bound / 0.5, rel=1e-12)
    assert read(obs, [], cfg) is None
    assert read({"frames": 2, "trace": {}}, _built_spans(), cfg) is None


def test_readers_read_the_profiled_window():
    """With no spans passed, a reader reads ``obs.trace.profiled()``."""
    read = _reader("serve.finalize_ms")
    with profile(activities=CPU):
        for _ in range(2):
            with tobs.span("slot.finalize"):
                time.sleep(2e-3)
    got = read({"frames": 2, "trace": {}})
    want = sum(s.dur_ms for s in ttrace.profiled().spans) / 2
    assert got == pytest.approx(want) and got >= 2.0


def test_frame_under_an_installed_tracer_is_bit_identical():
    """An installed tracer records the frame as one top-level ``frame``
    span and gives the same image as tracing off."""
    fns, acfg = _field(), tpl.ASDRConfig(**ACFG)
    tr = tobs.Tracer()
    img_off, _ = tpl.render_asdr_image(fns, acfg, _cam(), device="cpu")
    tobs.install(tr)
    try:
        img_on, _ = tpl.render_asdr_image(fns, acfg, _cam(), device="cpu")
    finally:
        tobs.uninstall(tr)
    tr.drain()
    np.testing.assert_array_equal(img_off.numpy(), img_on.numpy())
    assert [s.name for s in tr.spans if s.parent == 0] == ["frame"]
