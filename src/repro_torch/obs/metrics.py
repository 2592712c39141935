"""Metrics primitives and registry (``repro.obs.metrics``).

Everything numeric goes through four primitives:

  * ``Counter``   — monotone integer (mergeable by addition);
  * ``Gauge``     — last-write-wins value;
  * ``Histogram`` — fixed-bucket counts (mergeable by bucket addition;
    percentiles are bucket-upper-bound estimates, memory O(buckets));
  * ``Series``    — bounded ring of the most recent samples with EXACT
    percentiles over the window (memory O(capacity)), for wall-time
    ledgers of long-running loops.

``Registry`` names metrics, snapshots them as a flat dict, and appends
JSONL snapshots.

``percentile`` is the canonical nearest-rank implementation: the
smallest sample whose cumulative rank covers q% (rank = ceil(q/100*n)).
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest element whose cumulative
    rank reaches q% (rank = ceil(q/100 * n), 1-clamped).  0.0 on an
    empty series so stats stay JSON-clean before any sample landed.

    This fixes the historical ``int(len(s) * q / 100)`` bias: p50 of two
    samples is the LOWER one (rank ceil(1.0) = 1), not the max.
    """
    n = len(xs)
    if n == 0:
        return 0.0
    s = sorted(xs)
    rank = min(max(int(math.ceil(q / 100.0 * n)), 1), n)
    return float(s[rank - 1])


class Counter:
    """Monotone event count.  ``inc`` is the only mutator."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1):
        self.value += n

    def merge(self, other: "Counter"):
        self.value += other.value

    def read(self):
        return self.value


class Gauge:
    """Last-write-wins value (numeric or not)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self, value=0.0):
        self.value = value

    def set(self, v):
        self.value = v

    def read(self):
        return self.value


# default buckets for millisecond timings: ~1 us .. 16 s, x2 steps
DEFAULT_MS_BUCKETS = tuple(0.001 * 2 ** i for i in range(25))


class Histogram:
    """Fixed-bucket histogram: O(buckets) memory, mergeable by bucket
    addition (fleet replicas sum their histograms), percentile estimates
    quantized to bucket upper bounds."""

    kind = "histogram"

    def __init__(self, buckets: Iterable[float] = DEFAULT_MS_BUCKETS):
        self.bounds: List[float] = sorted(buckets)
        self.counts = [0] * (len(self.bounds) + 1)   # +inf overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float):
        lo, hi = 0, len(self.bounds)
        while lo < hi:                    # first bound >= v
            mid = (lo + hi) // 2
            if self.bounds[mid] >= v:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def merge(self, other: "Histogram"):
        assert self.bounds == other.bounds, "histogram buckets differ"
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def percentile(self, q: float) -> float:
        """Upper bound of the bucket holding the nearest-rank sample
        (exact ``max`` for the overflow bucket)."""
        if self.count == 0:
            return 0.0
        rank = min(max(int(math.ceil(q / 100.0 * self.count)), 1),
                   self.count)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return (self.bounds[i] if i < len(self.bounds)
                        else self.max)
        return self.max

    def read(self):
        return {"count": self.count, "sum": self.sum,
                "min": 0.0 if self.count == 0 else self.min,
                "max": 0.0 if self.count == 0 else self.max,
                "p50": self.percentile(50.0), "p99": self.percentile(99.0)}


class Series:
    """Bounded ring buffer of the most recent samples.

    EXACT nearest-rank percentiles over the retained window; ``count``
    keeps the all-time observation total.  This replaces the unbounded
    ``march_ms`` / latency lists: a long-running engine holds at most
    ``capacity`` floats per series while p50/p99 keep their meaning
    (percentiles of the recent window — for a bounded replay run,
    identical to the full-history percentiles).
    """

    kind = "series"

    def __init__(self, capacity: int = 4096):
        assert capacity > 0
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self.count = 0      # all-time observations (not window size)

    def observe(self, v: float):
        self._ring.append(float(v))
        self.count += 1

    def append(self, v: float):          # list-API compat
        self.observe(v)

    def __len__(self) -> int:
        return len(self._ring)

    def window(self) -> List[float]:
        return list(self._ring)

    def percentile(self, q: float) -> float:
        return percentile(self._ring, q)

    def read(self):
        return {"count": self.count, "p50": self.percentile(50.0),
                "p99": self.percentile(99.0)}


@dataclasses.dataclass
class _Named:
    metric: object
    help: str = ""


class Registry:
    """A named set of metrics with dict / JSONL views.

    ``engine_stats()`` is a read of a registry: serve/stats.py publishes
    every stats key as a gauge (``set_value``) next to the engine's
    structural counters, so one object backs the legacy dict, the text
    exposition, and the periodic snapshots.  Creation is
    get-or-create by (name, kind) — re-registering a name with a
    different kind raises.
    """

    def __init__(self):
        self._metrics: Dict[str, _Named] = {}
        self._lock = threading.Lock()

    # ---------------------------------------------------- constructors
    def _get(self, name: str, kind: str, factory):
        with self._lock:
            ent = self._metrics.get(name)
            if ent is None:
                ent = _Named(factory())
                self._metrics[name] = ent
            elif ent.metric.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{ent.metric.kind}, not {kind}")
            return ent.metric

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter", Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge", Gauge)

    def histogram(self, name: str,
                  buckets: Iterable[float] = DEFAULT_MS_BUCKETS
                  ) -> Histogram:
        return self._get(name, "histogram", lambda: Histogram(buckets))

    def series(self, name: str, capacity: int = 4096) -> Series:
        return self._get(name, "series", lambda: Series(capacity))

    def set_value(self, name: str, value):
        """Publish a computed value as a gauge (the engine_stats path)."""
        self.gauge(name).set(value)

    # ----------------------------------------------------------- views
    def names(self) -> List[str]:
        with self._lock:
            return list(self._metrics)

    def get(self, name: str):
        ent = self._metrics.get(name)
        return None if ent is None else ent.metric

    def snapshot(self) -> Dict:
        """Flat {name: value} dict — gauges/counters read raw, series
        and histograms read as summary sub-dicts.  Insertion-ordered, so
        publishing in engine_stats order preserves the legacy key
        order exactly."""
        with self._lock:
            return {name: ent.metric.read()
                    for name, ent in self._metrics.items()}

    def jsonl_snapshot(self, path, extra: Optional[Dict] = None):
        """Append one JSON line {ts, **extra, metrics: snapshot()} —
        the periodic form the benches consume."""
        rec = {"ts": time.time(), **(extra or {}),
               "metrics": self.snapshot()}
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")
