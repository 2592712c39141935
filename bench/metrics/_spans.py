"""The spans the port recorded in the traced window, for the per-layer
metrics timed inside the program: with no tracer installed, the port's
spans record while ``torch.profiler`` runs (``devtrace.traced``), and
``repro_torch.obs.trace.profiled()`` returns them after the window.

A program without that window, or a run with ``--trace 0``, has no
spans to read, and the readers then return None.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def recorded():
    """The traced window's spans, or None where the program recorded
    none."""
    try:
        from repro_torch.obs import trace
    except ImportError:
        return None
    profiled = getattr(trace, "profiled", None)
    tracer = profiled() if profiled is not None else None
    return tracer.spans if tracer is not None and tracer.spans else None


def ms_a_frame(obs, name: str, spans=None, device: bool = False,
               engine: bool = False):
    """Milliseconds a frame (``obs["frames"]``) of the spans called
    ``name``: their host durations, or with ``device`` their
    ``device_ms``; with ``engine``, only those on the engine lane (the
    lane of the ``pool.dispatch_round`` spans).  None where there are
    none."""
    spans = recorded() if spans is None else spans
    if not spans or not obs.get("frames"):
        return None
    got = [s for s in spans if s.name == name]
    if engine:
        lanes = {s.lane for s in spans if s.name == "pool.dispatch_round"}
        got = [s for s in got if s.lane in lanes]
    if device:
        got = [s.attrs["device_ms"] for s in got if "device_ms" in s.attrs]
    else:
        got = [(s.t1 - s.t0) * 1e3 for s in got]
    return sum(got) / obs["frames"] if got else None


def cell_config():
    """The configuration of the cell this process runs (``bench/run.py
    --workload``), or None outside a benchmark run."""
    from bench.harness import Cell

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload")
    name = p.parse_known_args(sys.argv[1:])[0].workload
    if name is None:
        return None
    return Cell.find(Path(__file__).resolve().parents[2], name).config
