"""Structured trace spans (``repro.obs.trace``).

A ``Tracer`` records nestable wall-time spans into PER-THREAD
append-only buffers — no locks anywhere on the hot path (a lock is
taken only the first time a thread emits a span, to register its
buffer).  The engine thread calls ``drain()`` once per scheduling
round, splicing every buffer's completed spans into the tracer's store,
feeding the flight recorder and the per-span-name metrics histograms.

Zero-overhead-when-off contract: instrumented call sites go through the
module-level ``span()`` / ``instant()`` helpers.  With no tracer
installed they return the shared ``NULL_SPAN`` singleton / return
immediately — a constant number of transient allocations per call site
(the kwargs dict), no buffers, no ids, no timestamps.  Frames and the
deterministic counters are bit-identical with tracing on or off: spans
only READ ids and clocks, never steer scheduling
(tests/test_torch_obs.py holds both properties).

Span identity: process-wide ids from one atomic counter; each span
records its parent (the innermost open span on ITS thread), so a
frame's lineage — admission -> stage_a -> probe/warp -> pool dispatch
-> collect — reconstructs from parent edges plus the structured attrs
(req/slot/batch/scene/shard/device ids) each layer stamps on its spans.
Lane = the recording thread's name (engine / serve-stage-a_* worker /
serve-dev* device queue / shard-* fetch pools).

Recording follows the profiler too: with no tracer installed, ``span()``
records into a process-wide tracer for the current profiled window while
``torch.profiler`` runs (torch's own ``_is_profiler_enabled`` flag, read
through ``sys.modules`` so this module imports no torch); ``profiled()``
returns that window's tracer, drained.  A window ends when ``span()``,
``instant()`` or ``profiled()`` sees the profiler stopped, and the next
profiled span opens a fresh one.

One clock with the device trace: spans keep ``perf_counter`` for their
durations, and every export puts them on the Unix-epoch clock that
``torch.profiler``'s events use (``Tracer.export_origin``).  A span
opened with ``device=True`` also records a CUDA timing event on the
current stream at entry and exit (obs/device_timer.py, imported only
then) and carries ``device_ms``, the stream time between them, once
drained; off the card it records nothing more.
"""
from __future__ import annotations

import dataclasses
import itertools
import sys
import threading
import time
from typing import Dict, List, Optional

from . import metrics as metrics_lib


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Engine-facing observability switchboard (RenderServeConfig.trace).

    All fields default to "collect in memory only"; exports happen at
    ``finish()`` (engine close).  ``metrics_jsonl``/``metrics_every``
    drive periodic registry snapshots from the engine loop.
    """
    path: Optional[str] = None           # Chrome/Perfetto JSON on finish
    jsonl: Optional[str] = None          # span-log JSONL on finish
    buffer_cap: int = 1 << 16            # per-thread buffer bound
    max_spans: int = 1 << 20             # drained-store bound
    flight: bool = False                 # keep a flight-recorder ring
    flight_capacity: int = 2048
    flight_path: Optional[str] = None    # default out/trace_flight.json
    # auto-arm a flight-recorder trigger: dump when an admission stall
    # span exceeds this many milliseconds (None = no auto trigger)
    stall_dump_ms: Optional[float] = None
    metrics_jsonl: Optional[str] = None  # periodic registry snapshots
    metrics_every: int = 16              # rounds between snapshots
    # ``replica`` stamps every exported event's Chrome ``pid`` (and a
    # process_name metadata row), so per-replica trace files merge into
    # one timeline (export.merge_chrome_traces) with one process group
    # per replica; exports share the Unix clock, so no origin is needed.
    replica: Optional[int] = None


@dataclasses.dataclass
class Span:
    """One closed span: [t0, t1) seconds on the tracer's clock."""
    name: str
    sid: int
    parent: int              # 0 = root
    lane: str                # recording thread's name
    t0: float
    t1: float
    attrs: Dict
    # a ``device=True`` span's CUDA timer until drain turns it into
    # ``attrs["device_ms"]``
    timer: object = dataclasses.field(default=None, repr=False,
                                      compare=False)

    @property
    def dur_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


class _ThreadBuf:
    """One thread's append-only span buffer + open-span stack.  Only the
    owner thread appends/pushes; only the drainer slices the front."""
    __slots__ = ("lane", "spans", "stack", "dropped")

    def __init__(self, lane: str):
        self.lane = lane
        self.spans: List[Span] = []
        self.stack: List[int] = []
        self.dropped = 0


class _SpanCtx:
    """Context manager for one live span (one per ``span()`` call)."""
    __slots__ = ("_tracer", "_buf", "name", "attrs", "sid", "_t0",
                 "_device", "_timer")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict,
                 device: bool = False):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._device = device

    def __enter__(self):
        tr = self._tracer
        buf = tr._buf()
        self._buf = buf
        self.sid = next(tr._ids)
        buf.stack.append(self.sid)
        self._timer = _device_timer() if self._device else None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if self._timer is not None:
            self._timer.stop()
        buf = self._buf
        buf.stack.pop()
        parent = buf.stack[-1] if buf.stack else 0
        if len(buf.spans) >= self._tracer.cfg.buffer_cap:
            buf.dropped += 1
        else:
            buf.spans.append(Span(self.name, self.sid, parent, buf.lane,
                                  self._t0, t1, self.attrs, self._timer))
        return False


def _device_timer():
    """A started CUDA timer on the current stream, or None off the card
    (the torch-touching part lives in obs/device_timer.py)."""
    from .device_timer import start
    return start()


class _NullSpan:
    """The disabled-mode singleton: enter/exit do nothing, allocate
    nothing.  Identity-tested by the zero-overhead gate."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    def __init__(self, cfg: TraceConfig = TraceConfig(),
                 registry: Optional[metrics_lib.Registry] = None,
                 recorder=None):
        self.cfg = cfg
        self.registry = registry        # span_ms histograms fed on drain
        self.recorder = recorder        # export.FlightRecorder or None
        self.t_origin = time.perf_counter()
        self.wall_origin = time.time()  # Unix time at t_origin
        self._ids = itertools.count(1)  # atomic under the GIL
        self._tls = threading.local()
        self._bufs: List[_ThreadBuf] = []
        self._reg_lock = threading.Lock()
        self.spans: List[Span] = []     # drained store (engine thread)
        self.dropped = 0

    # ------------------------------------------------------- hot path
    def _buf(self) -> _ThreadBuf:
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = _ThreadBuf(threading.current_thread().name)
            self._tls.buf = buf
            with self._reg_lock:        # once per (thread, tracer)
                self._bufs.append(buf)
        return buf

    def span(self, name: str, **attrs) -> _SpanCtx:
        """A span; ``device=True`` also times it on the current CUDA
        stream (any other ``device`` value is an ordinary attribute)."""
        device = attrs.get("device")
        if isinstance(device, bool):
            del attrs["device"]
        return _SpanCtx(self, name, attrs, device is True)

    def instant(self, name: str, **attrs):
        """Zero-duration marker span."""
        buf = self._buf()
        t = time.perf_counter()
        if len(buf.spans) >= self.cfg.buffer_cap:
            buf.dropped += 1
            return
        parent = buf.stack[-1] if buf.stack else 0
        buf.spans.append(Span(name, next(self._ids), parent, buf.lane,
                              t, t, attrs))

    # ---------------------------------------------------- engine side
    def drain(self) -> int:
        """Move every thread's completed spans into the tracer store
        (engine thread, once per round).  Owner threads keep appending
        concurrently: we copy the first n and delete exactly those, so
        no span is lost or double-drained."""
        moved = 0
        with self._reg_lock:
            bufs = list(self._bufs)
        for buf in bufs:
            n = len(buf.spans)
            if n:
                for sp in buf.spans[:n]:
                    if sp.timer is not None:
                        sp.attrs["device_ms"] = sp.timer.ms()
                        sp.timer = None
                self.spans.extend(buf.spans[:n])
                del buf.spans[:n]
                moved += n
            if buf.dropped:
                self.dropped += buf.dropped
                buf.dropped = 0
        if moved:
            if len(self.spans) > self.cfg.max_spans:
                over = len(self.spans) - self.cfg.max_spans
                del self.spans[:over]
                self.dropped += over
            new = self.spans[-moved:]
            if self.recorder is not None:
                self.recorder.record(new)
            if self.registry is not None:
                for s in new:
                    self.registry.histogram(
                        f"span_ms_{s.name}").observe(s.dur_ms)
        return moved

    def export_origin(self) -> float:
        """The origin exports subtract from ``perf_counter`` stamps so
        their timestamps land on the Unix-epoch clock, the one
        ``torch.profiler``'s events use: a program trace and the
        profiler's export of the same window make one timeline."""
        return self.t_origin - self.wall_origin

    def finish(self):
        """Final drain + configured exports.  Idempotent."""
        from . import export as export_lib
        self.drain()
        origin = self.export_origin()
        if self.cfg.path:
            export_lib.write_chrome_trace(self.cfg.path, self.spans,
                                          t_origin=origin,
                                          dropped=self.dropped,
                                          replica=self.cfg.replica)
        if self.cfg.jsonl:
            export_lib.write_span_jsonl(self.cfg.jsonl, self.spans,
                                        t_origin=origin,
                                        replica=self.cfg.replica)


# ------------------------------------------------------- module surface
_active: Optional[Tracer] = None


def install(tracer: Tracer):
    """Make ``tracer`` the process-wide active tracer.  One at a time:
    installing over a live tracer raises — a fleet that wants per-replica
    traces should trace one replica (or use explicit Tracer objects)."""
    global _active
    if _active is not None and _active is not tracer:
        raise RuntimeError("a tracer is already installed")
    _active = tracer


def uninstall(tracer: Optional[Tracer] = None):
    """Remove the active tracer (no-op if ``tracer`` isn't it)."""
    global _active
    if tracer is None or _active is tracer:
        _active = None


def active() -> Optional[Tracer]:
    return _active


def span(name: str, **attrs):
    """The instrumented-call-site helper: a real span when a tracer is
    installed or the profiler runs (``profiled``), the shared NULL_SPAN
    singleton otherwise."""
    t = _active or _profiled_window()
    return NULL_SPAN if t is None else t.span(name, **attrs)


def instant(name: str, **attrs):
    t = _active or _profiled_window()
    if t is not None:
        t.instant(name, **attrs)


# the profiled window: the tracer spans record into, with none installed,
# while torch.profiler runs; ``_window_open`` falls when the profiler is
# seen stopped, so the next profiled span starts a fresh window
_window: Optional[Tracer] = None
_window_open = False
_window_lock = threading.Lock()


def _profiler_running() -> bool:
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _profiled_window() -> Optional[Tracer]:
    global _window, _window_open
    if not _profiler_running():
        _window_open = False
        return None
    if not _window_open:
        with _window_lock:
            if not _window_open:
                _window = Tracer()
                _window_open = True
    return _window


def profiled() -> Optional[Tracer]:
    """The tracer of the current or last profiled window, drained; None
    when no span has recorded under the profiler."""
    global _window_open
    if not _profiler_running():
        _window_open = False
    if _window is not None:
        _window.drain()
    return _window
