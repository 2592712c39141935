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
"""
from __future__ import annotations

import dataclasses
import itertools
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
    # rate triggers (export.rate_trigger), each one-shot with rearm like
    # the stall trigger, each dumping to its own suffixed flight path:
    # an eviction storm is >= count scenecache.evict instants inside
    # window_ms; a shed burst is the same over scheduler.shed instants.
    # count 0 = trigger off.
    evict_storm_count: int = 0
    evict_storm_window_ms: float = 1000.0
    shed_burst_count: int = 0
    shed_burst_window_ms: float = 1000.0
    metrics_jsonl: Optional[str] = None  # periodic registry snapshots
    metrics_every: int = 16              # rounds between snapshots
    # cross-replica timeline identity: ``replica`` stamps every exported
    # event's Chrome ``pid`` (and a process_name metadata row), so
    # per-replica trace files merge into one timeline
    # (export.merge_chrome_traces) with one process group per replica.
    # ``epoch`` is a shared wall-clock origin (time.time() at fleet
    # start): exports rebase their timestamps onto it, so replicas
    # traced by SEPARATE tracers/processes line up on one clock.
    replica: Optional[int] = None
    epoch: Optional[float] = None


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
    __slots__ = ("_tracer", "_buf", "name", "attrs", "sid", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        tr = self._tracer
        buf = tr._buf()
        self._buf = buf
        self.sid = next(tr._ids)
        buf.stack.append(self.sid)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        buf = self._buf
        buf.stack.pop()
        parent = buf.stack[-1] if buf.stack else 0
        if len(buf.spans) >= self._tracer.cfg.buffer_cap:
            buf.dropped += 1
        else:
            buf.spans.append(Span(self.name, self.sid, parent, buf.lane,
                                  self._t0, t1, self.attrs))
        return False


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
        self.wall_origin = time.time()  # epoch anchor for export rebasing
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
        return _SpanCtx(self, name, attrs)

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
        """The t_origin exports subtract: the tracer's own start, or —
        with a shared ``epoch`` configured — the start rebased onto that
        wall clock, so separately-traced replicas share one timeline."""
        if self.cfg.epoch is None:
            return self.t_origin
        return self.t_origin - (self.wall_origin - self.cfg.epoch)

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
    installed, the shared NULL_SPAN singleton otherwise."""
    t = _active
    return NULL_SPAN if t is None else t.span(name, **attrs)


def instant(name: str, **attrs):
    t = _active
    if t is not None:
        t.instant(name, **attrs)
