"""Trace exports: Chrome/Perfetto JSON, span-log JSONL, flight recorder
(``repro.obs.export``; the same event fields, names and nesting).

The Chrome trace-event format (``{"traceEvents": [...]}``) opens
directly in https://ui.perfetto.dev (or chrome://tracing): every span
becomes one complete event (``ph: "X"``) with microsecond ts/dur, one
lane (``tid``) per recording thread, and the structured attrs —
req/slot/batch/scene/shard/device ids plus the span/parent ids — under
``args``.  Lane names are declared with ``thread_name`` metadata
events.

``FlightRecorder`` is the post-mortem mode: a bounded ring of the most
recent spans plus ``dump_on(predicate)`` triggers.  Each trigger is
ONE-SHOT — the first breaching span writes the ring to its path and
disarms the trigger (re-arm explicitly with ``rearm()``), so a
pathological steady-state (every admission stalling) produces one
post-mortem trace, not a disk-filling stream.
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from .trace import Span


def chrome_trace(spans: Sequence[Span], t_origin: float = 0.0,
                 dropped: int = 0,
                 replica: Optional[int] = None) -> Dict:
    """The Chrome trace-event dict for a span list (ts in microseconds
    after ``t_origin``; ``Tracer.export_origin`` puts them on the Unix
    clock of ``torch.profiler``'s events).

    ``replica`` becomes the Chrome ``pid`` of every event (plus a
    process_name metadata row), reserving the process axis for engine
    replicas: per-replica exports share the Unix clock and merge into
    one fleet timeline via ``merge_chrome_traces`` with one process
    group per replica."""
    pid = 1 if replica is None else int(replica)
    lanes: Dict[str, int] = {}
    events: List[Dict] = []
    for s in spans:
        tid = lanes.setdefault(s.lane, len(lanes) + 1)
        events.append({
            "name": s.name, "ph": "X", "pid": pid, "tid": tid,
            "ts": (s.t0 - t_origin) * 1e6,
            "dur": (s.t1 - s.t0) * 1e6,
            "args": {**s.attrs, "sid": s.sid, "parent": s.parent},
        })
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": lane}} for lane, tid in lanes.items()]
    if replica is not None:
        meta.insert(0, {"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "args": {"name": f"replica-{pid}"}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": dropped}}


def write_chrome_trace(path, spans: Sequence[Span], t_origin: float = 0.0,
                       dropped: int = 0,
                       replica: Optional[int] = None) -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(chrome_trace(spans, t_origin, dropped,
                                         replica=replica),
                            default=str))
    return p


def merge_chrome_traces(traces: Sequence) -> Dict:
    """Merge Chrome trace exports into ONE timeline dict.

    Inputs are trace dicts or paths to trace files: per-replica exports
    as ``write_chrome_trace`` writes them, each with a distinct
    ``replica`` (pid), and ``torch.profiler`` exports of the same window.
    Program exports are on the Unix clock already; a profiler export
    counts its ts from ``baseTimeNanoseconds`` and is moved onto it, and
    its process rows for devices with no events (it names every device
    the build knows) are left out.  Events keep their pid; span/parent
    ids live under per-pid namespaces, which is how a merged file is
    read."""
    events: List[Dict] = []
    dropped = 0
    seen_pids = set()
    replicas = set()        # the pids of the program's exports
    for t in traces:
        if not isinstance(t, dict):
            t = json.loads(Path(t).read_text())
        evs = t["traceEvents"]
        base_ns = t.get("baseTimeNanoseconds")
        if base_ns is not None:
            live = {e.get("pid") for e in evs if e.get("ph") != "M"}
            evs = [{**e, "ts": e["ts"] + base_ns / 1e3} if "ts" in e else e
                   for e in evs if e.get("ph") != "M" or e.get("pid") in live]
        pids = {e.get("pid") for e in evs}
        overlap = pids & seen_pids
        if overlap:
            raise ValueError(f"duplicate replica pid(s) in merge: "
                             f"{sorted(overlap, key=str)} — stamp each "
                             f"replica's TraceConfig.replica uniquely")
        seen_pids |= pids
        if base_ns is None:
            replicas |= pids
        events.extend(evs)
        dropped += t.get("otherData", {}).get("dropped_spans", 0)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": dropped,
                          "replicas": sorted(replicas)}}


def write_span_jsonl(path, spans: Sequence[Span],
                     t_origin: float = 0.0,
                     replica: Optional[int] = None) -> Path:
    """One JSON object per span — the grep/jq-friendly log form."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    rep = {} if replica is None else {"replica": int(replica)}
    with open(p, "a") as f:
        for s in spans:
            f.write(json.dumps({
                "name": s.name, "sid": s.sid, "parent": s.parent,
                "lane": s.lane, "t0_us": (s.t0 - t_origin) * 1e6,
                "dur_us": (s.t1 - s.t0) * 1e6, **rep, **s.attrs,
            }, default=str) + "\n")
    return p


@dataclasses.dataclass
class _Trigger:
    predicate: Callable[[Span], bool]
    path: str
    armed: bool = True
    fired: int = 0
    fired_on: Optional[int] = None     # sid of the breaching span


class FlightRecorder:
    """Bounded ring of recent spans + one-shot dump triggers.

    ``record`` is called from the tracer's drain (engine thread): spans
    enter the ring, then every ARMED trigger tests them; the first
    breach writes the ring (breaching span included) as a Chrome trace
    to the trigger's path and disarms it — exactly one dump per breach
    episode.
    """

    def __init__(self, capacity: int = 2048, t_origin: float = 0.0,
                 replica: Optional[int] = None):
        self.ring: deque = deque(maxlen=capacity)
        self.triggers: List[_Trigger] = []
        self.t_origin = t_origin
        self.replica = replica

    def dump_on(self, predicate: Callable[[Span], bool],
                path) -> _Trigger:
        """Arm a trigger: the first recorded span with
        ``predicate(span)`` true dumps the ring to ``path``."""
        trig = _Trigger(predicate, str(path))
        self.triggers.append(trig)
        return trig

    def rearm(self):
        for trig in self.triggers:
            trig.armed = True

    def record(self, spans: Sequence[Span]) -> int:
        fired = 0
        for s in spans:
            self.ring.append(s)
            for trig in self.triggers:
                if trig.armed and trig.predicate(s):
                    trig.armed = False
                    trig.fired += 1
                    trig.fired_on = s.sid
                    write_chrome_trace(trig.path, list(self.ring),
                                       t_origin=self.t_origin,
                                       replica=self.replica)
                    fired += 1
        return fired


def stall_trigger(threshold_ms: float) -> Callable[[Span], bool]:
    """The canonical auto-trigger: an admission wait/stall span longer
    than ``threshold_ms`` (what ``TraceConfig.stall_dump_ms`` arms)."""
    def pred(s: Span) -> bool:
        return s.name == "admission.wait" and s.dur_ms > threshold_ms
    return pred
