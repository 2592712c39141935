"""Tracing and metrics for the reuse and serving stack (``repro.obs``).

Pure Python (torch only in ``device_timer``, loaded on first use): the
port keeps its own copy so it imports nothing of the reference package.  Three modules, one contract:

  * ``trace``   — Tracer, nestable spans, per-thread lock-free buffers,
    the zero-overhead-when-off ``span()`` helper, the profiled window
    (``profiled()``) and device-timed spans (``device_timer``, the one
    module that imports torch, loaded only by a recording device span);
  * ``export``  — Chrome/Perfetto JSON + span JSONL + FlightRecorder;
  * ``metrics`` — Counter/Gauge/Histogram/Series primitives, Registry,
    the canonical nearest-rank ``percentile``.
"""
from . import export, metrics, trace  # noqa: F401
from .metrics import Registry, percentile  # noqa: F401
from .trace import (NULL_SPAN, Span, TraceConfig, Tracer, active,  # noqa: F401
                    install, instant, profiled, span, uninstall)

__all__ = ["trace", "export", "metrics", "Registry", "percentile",
           "TraceConfig", "Tracer", "Span", "span", "instant", "install",
           "uninstall", "active", "profiled", "NULL_SPAN", "engine_tracer"]


def engine_tracer(cfg, registry=None):
    """Build + INSTALL a Tracer for a ``TraceConfig`` (None -> None).

    The engine-side constructor: wires the flight recorder (auto-arming
    the stall trigger when the config asks for it) and the metrics
    registry into the tracer, then makes it the process-wide active
    tracer so every instrumented layer records into it.  The caller
    owns the lifecycle: ``tracer.finish()`` + ``uninstall(tracer)`` on
    engine close.
    """
    if cfg is None:
        return None
    recorder = None
    if cfg.flight or cfg.stall_dump_ms is not None:
        recorder = export.FlightRecorder(cfg.flight_capacity,
                                         replica=cfg.replica)
        if cfg.stall_dump_ms is not None:
            recorder.dump_on(export.stall_trigger(cfg.stall_dump_ms),
                             cfg.flight_path or "out/trace_flight.json")
    tracer = Tracer(cfg, registry=registry, recorder=recorder)
    if recorder is not None:
        recorder.t_origin = tracer.export_origin()
    install(tracer)
    return tracer
