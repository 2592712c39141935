"""Port parity: the tracing and metrics layer (obs/) against ``repro.obs``.

Metrics and percentiles equal the reference's on the same observations;
the same span sequence gives the same span names, ids, parents, lanes and
attrs; exports and flight-recorder dumps have the reference's schema
(equal dicts, ``tools/check_trace.py`` finds nothing); tracing on and off
give bit-identical frames and stats on a reuse trajectory, whose spans
equal the reference's on the same trajectory.  The port's own: spans
record under ``torch.profiler`` with no tracer installed, exports share
the profiler's Unix clock, the frame's phase spans, the server's host
spans and Stage-A placement counters, and the benchmark's span readers.
"""
import json
import sys
import threading
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import framecache as jfc
from repro import obs as jobs
from repro import scenecache as jsc_
from repro.core import fields as jfields
from repro.core import pipeline as jpl
from repro.core import scene as jsc
from repro_torch import framecache as tfc
from repro_torch import obs as tobs
from repro_torch import scenecache as tsc_
from repro_torch.core import fields as tfields
from repro_torch.core import pipeline as tpl
from repro_torch.core import scene as tsc

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import check_trace  # noqa: E402

ACFG = dict(ns_full=48, probe_stride=4, candidates=(8, 16, 32), block_size=64,
            chunk=16)
SIZE = 24
TRAJ = tuple(0.7 + 0.01 * k for k in range(5))


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    assert tobs.active() is None and jobs.active() is None
    yield
    assert tobs.active() is None and jobs.active() is None


# ---------------------------------------------------------------- metrics
@pytest.mark.parametrize("xs", [[], [7.0], [1.0, 2.0], [2.0, 1.0],
                                list(range(1, 101)), [3.5, -1.0, 2.0, 2.0]])
@pytest.mark.parametrize("q", [0.0, 50.0, 99.0, 100.0])
def test_percentile_equal(xs, q):
    assert tobs.percentile(xs, q) == jobs.percentile(xs, q)


def _fill(mod, values):
    reg = mod.Registry()
    reg.counter("frames").inc(3)
    reg.gauge("fps").set(12.5)
    reg.gauge("flags").set({"a": 1, "b": True, "c": "x"})
    h, s = reg.histogram("span_ms_probe.plan"), reg.series("march_ms", 16)
    other = mod.metrics.Histogram()
    for v in values:
        h.observe(v)
        s.observe(v)
        other.observe(2 * v)
    h.merge(other)
    return reg


def test_registry_equal(tmp_path):
    values = np.random.default_rng(0).lognormal(0.0, 2.0, 100).tolist()
    t, j = _fill(tobs, values), _fill(jobs, values)
    assert t.snapshot() == j.snapshot()
    assert t.names() == j.names()
    lines = []
    for reg, name in ((t, "t.jsonl"), (j, "j.jsonl")):
        reg.jsonl_snapshot(tmp_path / name, extra={"round": 1})
        rec = json.loads((tmp_path / name).read_text())
        del rec["ts"]
        lines.append(rec)
    assert lines[0] == lines[1]
    with pytest.raises(ValueError):
        t.gauge("frames")


# ---------------------------------------------------------------- tracing
def _scripted(mod, buffer_cap=1 << 16):
    """A fixed span sequence: nesting, an instant, a worker thread and
    buffer drops; returns the drained spans without their clocks."""
    tr = mod.Tracer(mod.TraceConfig(buffer_cap=buffer_cap))
    mod.install(tr)
    try:
        with mod.span("probe.plan", req=1) as sp:
            sp.attrs["kind"] = "fresh"
            with mod.span("probe.execute", kind="fresh"):
                mod.instant("scenecache.hit")
            with mod.span("probe.commit", kind="fresh"):
                pass

        def worker():
            for i in range(3):
                with mod.span("scenecache.lookup", shard=i):
                    pass

        t = threading.Thread(target=worker, name="scenecache-fetch_0")
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        for i in range(6):
            mod.instant("scenecache.evict", bytes=i)
        tr.drain()
    finally:
        mod.uninstall(tr)
    return [(s.name, s.sid, s.parent, s.lane, s.attrs) for s in tr.spans], \
        tr.dropped


@pytest.mark.parametrize("buffer_cap", [4, 1 << 16])
def test_span_names_and_nesting_equal(buffer_cap):
    got = _scripted(tobs, buffer_cap)
    assert got == _scripted(jobs, buffer_cap)
    assert (got[1] > 0) == (buffer_cap == 4)


def _spans(mod):
    S = mod.Span
    return [S("radiance.plan", 1, 0, "MainThread", 10.0, 10.002,
              {"kind": "hit"}),
            S("warp.image", 2, 1, "MainThread", 10.0005, 10.0015,
              {"pixels": 576}),
            S("scenecache.lookup", 3, 0, "scenecache-fetch_0", 10.001,
              10.003, {"shard": 1}),
            S("scenecache.hit", 4, 0, "MainThread", 10.004, 10.004, {})]


@pytest.mark.parametrize("replica", [None, 3])
def test_export_schema_equal(tmp_path, replica):
    kw = dict(t_origin=9.5, dropped=2, replica=replica)
    got = tobs.export.chrome_trace(_spans(tobs), **kw)
    assert got == jobs.export.chrome_trace(_spans(jobs), **kw)
    path = tobs.export.write_chrome_trace(tmp_path / "t.json", _spans(tobs),
                                          **kw)
    assert check_trace.check_file(path) == []
    assert json.loads(path.read_text()) == json.loads(json.dumps(got))
    for mod, name in ((tobs, "t.jsonl"), (jobs, "j.jsonl")):
        mod.export.write_span_jsonl(tmp_path / name, _spans(mod), 9.5,
                                    replica)
    assert ((tmp_path / "t.jsonl").read_text()
            == (tmp_path / "j.jsonl").read_text())
    other = tobs.export.chrome_trace(_spans(tobs), replica=7)
    merged = tobs.export.merge_chrome_traces([got, other])
    assert merged == jobs.export.merge_chrome_traces([got, other])
    with pytest.raises(ValueError):
        tobs.export.merge_chrome_traces([other, other])


def test_flight_recorder_and_triggers_equal(tmp_path):
    """The same spans through both recorders: the same firings and the
    same dumped bytes; the stall trigger ``engine_tracer`` arms."""
    dumps = []
    for mod in (tobs, jobs):
        rec = mod.export.FlightRecorder(capacity=4)
        stall = rec.dump_on(mod.export.stall_trigger(10.0),
                            tmp_path / f"{mod.__name__}_stall.json")
        spans = [mod.Span("admission.wait", i, 0, "engine", 0.01 * i,
                          0.01 * i + 1e-3 * (5 + 20 * (i % 2)), {})
                 for i in range(1, 6)]
        fired = [rec.record([s]) for s in spans]
        rec.rearm()
        fired.append(rec.record(spans[:2]))
        dumps.append((fired, stall.fired, stall.fired_on,
                      (tmp_path / f"{mod.__name__}_stall.json").read_bytes()))
    assert dumps[0] == dumps[1]
    cfg = tobs.TraceConfig(stall_dump_ms=5.0,
                           flight_path=str(tmp_path / "fl.json"))
    tr = tobs.engine_tracer(cfg)
    try:
        assert tobs.active() is tr
        assert [t.path for t in tr.recorder.triggers] == [
            str(tmp_path / "fl.json")]
    finally:
        tobs.uninstall(tr)
    assert tobs.engine_tracer(None) is None


def test_disabled_mode_is_free():
    """No tracer: span() is the shared NULL_SPAN and 10k call sites retain
    no memory beyond a small constant."""
    assert tobs.span("probe.plan") is tobs.NULL_SPAN

    def call_site(i):
        with tobs.span("probe.plan", req=i):
            with tobs.span("warp.count_map", pixels=i):
                tobs.instant("scenecache.hit")

    call_site(0)
    tracemalloc.start()
    try:
        base, _ = tracemalloc.get_traced_memory()
        for i in range(10_000):
            call_site(i)
        now, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert now - base < 64 << 10


# ----------------------------------------------- a traced reuse trajectory
def _trajectory(fc_mod, sc_mod, pl, sc, fns, tracer=None, **kw):
    fc = fc_mod.make_frame_cache(scene_cache=sc_mod.SceneBlockCache(),
                                 scene_id="mic")
    acfg = pl.ASDRConfig(**ACFG)
    out = []
    if tracer is not None:
        tracer_mod = tobs if fc_mod is tfc else jobs
        tracer_mod.install(tracer)
    try:
        for th in TRAJ:
            cam = sc.look_at_camera(SIZE, SIZE, theta=th, phi=0.5)
            out.append(fc_mod.render_asdr_image_cached(fns, acfg, cam, fc,
                                                       **kw))
    finally:
        if tracer is not None:
            tracer_mod.uninstall(tracer)
            tracer.drain()
    return out, fc.scene.stats()


def _span_tree(tracer):
    """(name, index of the parent span or -1, attrs) in recording order."""
    at = {s.sid: i for i, s in enumerate(tracer.spans)}
    return [(s.name, at.get(s.parent, -1), s.attrs) for s in tracer.spans]


def test_tracing_on_off_bit_identical_and_spans_equal(tmp_path):
    ft = tfields.analytic_field_fns(tsc.make_scene("mic"))
    fj = jfields.analytic_field_fns(jsc.make_scene("mic"))
    off, st_off = _trajectory(tfc, tsc_, tpl, tsc, ft, device="cpu")
    tr = tobs.Tracer(tobs.TraceConfig(path=str(tmp_path / "trace.json")))
    on, st_on = _trajectory(tfc, tsc_, tpl, tsc, ft, tr, device="cpu")
    assert st_on == st_off
    for (img_a, s_a), (img_b, s_b) in zip(off, on):
        assert torch.equal(img_a, img_b)
        assert s_a.keys() == s_b.keys()
        for k in s_a:
            a, b = s_a[k], s_b[k]
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b), k
    names = {s.name for s in tr.spans}
    assert {"probe.plan", "probe.execute", "probe.commit", "warp.count_map",
            "warp.image", "radiance.plan", "radiance.commit",
            "scenecache.store"} <= names
    tr.finish()
    assert check_trace.check_file(tmp_path / "trace.json") == []
    jtr = jobs.Tracer(jobs.TraceConfig())
    _trajectory(jfc, jsc_, jpl, jsc, fj, jtr)
    # the port's store spans also carry the eviction index's ``examined``
    got = _span_tree(tr)
    assert all(isinstance(a.get("examined"), int) for n, _, a in got
               if n == "scenecache.store")
    assert [(n, p, {k: v for k, v in a.items() if k != "examined"})
            for n, p, a in got] == _span_tree(jtr)


# ------------------------------------------------------ engine integration
def _engine_run(rcfg, n=6):
    from test_torch_render_serve import acfgs, field_pairs, requests
    from repro_torch.serve import render_engine as tre
    eng = tre.RenderServingEngine({"mic": field_pairs()["mic"][1]},
                                  acfgs()[1], rcfg, device="cpu")
    reqs = requests([(i, "mic", 0.7 + 0.05 * (i % 3), 0.5)
                     for i in range(n)])[1]
    done = {r.rid: r for r in eng.render(reqs)}
    st = eng.engine_stats()
    spans = list(eng.tracer.spans) if eng.tracer is not None else None
    eng.close()
    return done, st, spans


def test_engine_trace_off_by_default():
    from test_torch_render_serve import acfgs, field_pairs
    from repro_torch.serve import render_engine as tre
    assert tre.RenderServeConfig().trace is None
    eng = tre.RenderServingEngine({"mic": field_pairs()["mic"][1]},
                                  acfgs()[1], device="cpu")
    assert eng.tracer is None
    eng.close()


@pytest.mark.parametrize("workers,prefetch", [(0, 0), (0, 2), (2, 0), (2, 2)])
def test_engine_bit_identity_tracing_on_off(workers, prefetch, tmp_path):
    """The engine's frames and every deterministic counter are identical
    with tracing on and off, for the sync and threaded executors x
    prefetch {0, 2}; the worker speculation lands on ``serve-stage-a``
    lanes and the export passes the reference's validator."""
    import dataclasses
    from test_torch_render_serve import serve_cfgs
    from repro_torch.serve.stats import DETERMINISTIC_COUNTERS
    base = serve_cfgs(slots=2, blocks_per_batch=4, workers=workers,
                      prefetch=prefetch, reuse=dict(refresh_every=0),
                      radiance=dict(refresh_every=0))[1]
    traced = dataclasses.replace(base, trace=tobs.TraceConfig(
        path=str(tmp_path / "t.json"), flight=True, stall_dump_ms=1e9))
    d_off, st_off, _ = _engine_run(base)
    d_on, st_on, spans = _engine_run(traced)
    assert d_off.keys() == d_on.keys()
    for rid in d_off:
        np.testing.assert_array_equal(d_off[rid].image, d_on[rid].image)
    for k in DETERMINISTIC_COUNTERS:
        assert st_off[k] == st_on[k], k
    assert spans
    runs = [s for s in spans if s.name == "executor.run"]
    if workers and prefetch:
        assert runs and all(s.lane.startswith("serve-stage-a") for s in runs)
    assert check_trace.check_file(tmp_path / "t.json") == []


def test_engine_trace_reconstructs_lineage(tmp_path):
    """A replayed frame's trace chains admission -> dispatch -> collect ->
    commit with matching req/batch ids, as the reference's does."""
    from test_torch_render_serve import serve_cfgs
    path = tmp_path / "trace.json"
    rcfg = serve_cfgs(slots=2, blocks_per_batch=4,
                      reuse=dict(refresh_every=0),
                      scenecache=dict(byte_budget=4 << 20), prefetch=2)[1]
    import dataclasses
    rcfg = dataclasses.replace(rcfg, trace=tobs.TraceConfig(path=str(path)))
    done, _, spans = _engine_run(rcfg)
    assert len(done) == 6
    names = {s.name for s in spans}
    for required in ("admission.wait", "stage_a.prepare", "stage_b.admit",
                     "commit", "pool.sweep", "pool.dispatch_round",
                     "pool.dispatch", "pool.collect", "probe.plan",
                     "probe.execute", "probe.commit"):
        assert required in names, f"missing span {required}"
    waits = [s for s in spans if s.name == "admission.wait"]
    assert {s.attrs["req"] for s in waits} == set(done)
    by_sid = {s.sid: s for s in spans}
    for s in spans:
        if s.name == "stage_b.admit":
            parent = by_sid[s.parent]
            assert parent.name == "admission.wait"
            assert parent.attrs["req"] == s.attrs["req"]
    dispatches = {s.attrs["batch"]: s for s in spans
                  if s.name == "pool.dispatch"}
    collects = {s.attrs["batch"]: s for s in spans
                if s.name == "pool.collect"}
    assert dispatches and set(collects) == set(dispatches)
    for bid, d in dispatches.items():
        assert collects[bid].attrs["reqs"] == d.attrs["reqs"]
        assert d.attrs["scene"] == "mic"
        assert d.attrs["device_ms"] > 0.0
    assert check_trace.check_file(path) == []


def test_engine_stats_is_registry_read():
    """engine_stats() keys survive the registry round-trip exactly."""
    from test_torch_render_serve import serve_cfgs
    _, st, _ = _engine_run(serve_cfgs(slots=2, blocks_per_batch=4)[1], n=4)
    for k in ("frames", "latency_ms_p50", "latency_ms_p99",
              "admit_stall_ms_p50", "admit_stall_ms_p99",
              "march_ms_p50", "march_ms_p99", "march_rounds",
              "batches_per_round"):
        assert k in st, k
    assert st["frames"] == 4
    assert st["latency_ms_p99"] >= st["latency_ms_p50"] > 0
    assert max(st["batches_per_round"]) >= 1
