"""Tracing and metrics for the reuse and serving stack (``repro.obs``).

Pure Python, no torch: the port keeps its own copy so it imports nothing
of the reference package.  Three modules, one contract:

  * ``trace``   — Tracer, nestable spans, per-thread lock-free buffers,
    the zero-overhead-when-off ``span()`` helper;
  * ``export``  — Chrome/Perfetto JSON + span JSONL + FlightRecorder;
  * ``metrics`` — Counter/Gauge/Histogram/Series primitives, Registry,
    the canonical nearest-rank ``percentile``.
"""
from . import export, metrics, trace  # noqa: F401
from .metrics import Registry, percentile  # noqa: F401
from .trace import (NULL_SPAN, Span, TraceConfig, Tracer, active,  # noqa: F401
                    install, instant, span, uninstall)

__all__ = ["trace", "export", "metrics", "Registry", "percentile",
           "TraceConfig", "Tracer", "Span", "span", "instant", "install",
           "uninstall", "active", "NULL_SPAN", "engine_tracer"]


def engine_tracer(cfg, registry=None):
    """Build + INSTALL a Tracer for a ``TraceConfig`` (None -> None).

    The engine-side constructor: wires the flight recorder (auto-arming
    the stall / eviction-storm / shed-burst triggers the config asks
    for, each dumping to its own suffixed flight path) and the metrics
    registry into the tracer, then makes it the process-wide active
    tracer so every instrumented layer records into it.  The caller
    owns the lifecycle: ``tracer.finish()`` + ``uninstall(tracer)`` on
    engine close.
    """
    if cfg is None:
        return None
    recorder = None
    want_triggers = (cfg.stall_dump_ms is not None
                     or cfg.evict_storm_count > 0
                     or cfg.shed_burst_count > 0)
    if cfg.flight or want_triggers:
        recorder = export.FlightRecorder(cfg.flight_capacity,
                                         replica=cfg.replica)
        base = cfg.flight_path or "out/trace_flight.json"
        if cfg.stall_dump_ms is not None:
            recorder.dump_on(export.stall_trigger(cfg.stall_dump_ms), base)
        if cfg.evict_storm_count > 0:
            recorder.dump_on(
                export.evict_storm_trigger(cfg.evict_storm_count,
                                           cfg.evict_storm_window_ms),
                export.trigger_path(base, "evict_storm"))
        if cfg.shed_burst_count > 0:
            recorder.dump_on(
                export.shed_burst_trigger(cfg.shed_burst_count,
                                          cfg.shed_burst_window_ms),
                export.trigger_path(base, "shed_burst"))
    tracer = Tracer(cfg, registry=registry, recorder=recorder)
    if recorder is not None:
        recorder.t_origin = tracer.export_origin()
    install(tracer)
    return tracer
