"""Pluggable Stage-A execution backends for the serving pipeline
(``repro.serve.executor``).

The executor contract:

  * ``submit(key, fn)`` — schedule ``fn()`` (a Stage-A ``prepare``
    closure: plans + probe/warp device work + pad/sort layout) for
    ``key``.  Idempotent: a key already submitted and not yet taken is
    NOT resubmitted.  Raises RuntimeError after ``close()``.
  * ``take(key)`` — the finished result, blocking if still in flight;
    None if the key was never submitted (the engine then prepares
    inline).  Engine thread only.  Every submitted key must eventually
    be taken or reset — ``pending()`` counts what hasn't been.  It
    leaves where Stage A ran in ``last_take`` (``STAGE_A``): ``ready``
    (finished at take), ``waited`` (the engine blocked on a busy
    worker), ``stolen`` (never started, run on the engine thread) or
    ``inline`` (never submitted).
  * ``reset()`` — drop pending speculation (end of a render() call).
    Idempotent.
  * ``close()`` — release worker resources.  Idempotent; the executor
    rejects new submissions afterwards.

Backends move WHERE and WHEN the speculation executes; they never change
WHAT is committed — Stage B revalidates every plan against current cache
state on the engine thread, so rendered frames and the deterministic
counters are bit-identical across backends.

``SyncExecutor`` (the default) runs ``fn`` inline at submit time on the
engine thread: the speculation overlaps only the HOST-side gap while the
dispatched round — up to ``inflight_batches`` back-to-back march batches
(pool.dispatch_round) — is in flight on the card.
``ThreadedExecutor`` runs it on worker threads, each with a CUDA stream
of its own: the probe/warp kernels go to the worker's stream and run
beside the march on the engine's stream.  A worker records an event on
its stream after the closure and synchronizes it, so the result is
complete on the card before the engine takes it; ``take`` then makes the
engine's stream wait on that event and ``record_stream``-s the result's
tensors to the engine's stream, so the caching allocator cannot hand a
buffer the worker allocated to the worker's stream again while engine
work that reads it is still queued.  ``DeviceExecutor`` places each
speculation on a secondary card (``cuda:1`` ..) with that card current,
a stream of that card's own, and the card named by ``placement()``;
``take`` copies the result to the engine's card.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..obs import trace as trace_lib


def _available_devices() -> List[torch.device]:
    """The CUDA device list (module hook so tests can model single- and
    multi-device hosts)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


_placed = threading.local()

# where a take found its Stage A (``last_take``), in report order
STAGE_A = ("ready", "waited", "stolen", "inline")


def placement() -> Optional[torch.device]:
    """The device this thread's Stage-A closure was placed on by a
    ``DeviceExecutor``; None where no placement was made (sync, threaded,
    a stolen take on the engine thread), which means the engine's card."""
    return getattr(_placed, "device", None)


def indexed(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` names this thread's
    current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class SyncExecutor:
    """Inline (engine-thread) Stage-A execution — the default backend."""

    workers = 0
    backend = "sync"
    last_take = None

    def __init__(self):
        self._done: Dict = {}
        self._closed = False

    def submit(self, key, fn: Callable):
        if self._closed:
            raise RuntimeError("submit() on a closed executor")
        if key not in self._done:
            # sync backend runs the closure AT submit — the span covers
            # the actual Stage-A execution on the engine lane
            with trace_lib.span("executor.submit", backend=self.backend):
                self._done[key] = fn()

    def take(self, key):
        out = self._done.pop(key, None)
        self.last_take = "inline" if out is None else "ready"
        return out

    def pending(self) -> int:
        """Submitted-but-not-taken keys (0 after a clean render())."""
        return len(self._done)

    def depth(self) -> Dict[str, int]:
        """Queue-depth gauge sample (scheduler stall projections read
        this through the metrics registry).  Sync results are complete
        at submit, so nothing is ever in flight."""
        return {"pending": len(self._done), "inflight": 0}

    def reset(self):
        """Drop pending speculation (end of a render() call): results are
        keyed by id(request), and a key must never outlive the call that
        submitted it — a later call's request can reuse the id."""
        self._done.clear()

    def close(self):
        self._done.clear()
        self._closed = True


def _device_tensors(out) -> List[torch.Tensor]:
    tensors = getattr(out, "tensors", None)
    return [] if tensors is None else [
        t for t in tensors() if t is not None and t.is_cuda]


def _handover(out, event, device=None):
    """Make a worker's result safe on the engine's streams: each stream
    that will read it waits on the worker's event, and each tensor is
    recorded as in use there (``record_stream``).  With ``device`` (the
    engine's card), a result that lies elsewhere is then copied there
    (``out.to_device``): the copy runs on the placing card's current
    stream, which is the stream waited on and recorded, and the engine's
    stream waits on the copy."""
    for t in _device_tensors(out):
        stream = torch.cuda.current_stream(t.device)
        if event is not None:
            stream.wait_event(event)
        t.record_stream(stream)
    if device is None or not hasattr(out, "to_device"):
        return out
    return out.to_device(device)


class _FutureExecutor:
    """Shared future-backed machinery for the off-thread backends.

    Subclasses provide ``_spawn(key, fn) -> Future`` whose result is
    ``(out, event)``: the closure's result and the CUDA event recorded
    after it on the stream it ran on (None off the card).  ``take``
    WORK-STEALS: a speculation still queued (its future never started)
    is cancelled and run inline on the engine thread instead of waiting
    for a busy worker — the engine must never stall behind speculation
    it could execute itself.
    """

    device = None     # the engine's card: where ``take`` hands results
    last_take = None

    def __init__(self):
        self._futs: Dict[object, Tuple[Future, Callable]] = {}
        self._closed = False

    def _spawn(self, key, fn: Callable) -> Future:
        raise NotImplementedError

    def submit(self, key, fn: Callable):
        if self._closed:
            raise RuntimeError("submit() on a closed executor")
        if key not in self._futs:
            self._futs[key] = (self._spawn(key, fn), fn)

    backend = "future"

    def take(self, key):
        ent = self._futs.pop(key, None)
        if ent is None:
            self.last_take = "inline"
            return None
        fut, fn = ent
        if fut.cancel():          # never started: steal it inline
            self.last_take = "stolen"
            with trace_lib.span("executor.take", backend=self.backend,
                                stolen=True):
                return fn()
        self.last_take = "ready" if fut.done() else "waited"
        # the span covers the engine-side WAIT for a busy worker — on an
        # idle executor it closes immediately; long takes here mean
        # speculation is not keeping ahead of admission
        with trace_lib.span("executor.take", backend=self.backend,
                            stolen=False):
            return _handover(*fut.result(), device=self.device)

    def pending(self) -> int:
        return len(self._futs)

    def depth(self) -> Dict[str, int]:
        """Queue-depth gauge sample: ``pending`` = submitted-not-taken
        speculations, ``inflight`` = the subset actually EXECUTING on a
        worker right now (the rest are queued behind the concurrency
        cap — a growing pending/inflight gap means speculation is
        falling behind admission)."""
        running = sum(1 for fut, _fn in self._futs.values()
                      if fut.running())
        return {"pending": len(self._futs), "inflight": running}

    def reset(self):
        """Drop pending speculation (see SyncExecutor.reset).  Unstarted
        futures are cancelled; running ones finish on their worker and
        are discarded.  Idempotent."""
        for fut, _fn in self._futs.values():
            fut.cancel()
        self._futs.clear()

    def close(self):
        self.reset()
        self._closed = True


def _run_on_stream(stream: Optional[torch.cuda.Stream], fn: Callable):
    """``fn()`` with ``stream`` current (None: as it is), then the event
    recorded after it on that stream, synchronized here on the worker, so
    the result is complete on the card when the engine takes it.
    Returns (out, event)."""
    if stream is None:
        return fn(), None
    with torch.cuda.stream(stream):
        out = fn()
        event = torch.cuda.Event()
        event.record(stream)
    _wait_device_ready(event)
    return out, event


def _wait_device_ready(event: torch.cuda.Event):
    event.synchronize()


class ThreadedExecutor(_FutureExecutor):
    """Worker-thread Stage-A execution, one CUDA stream per worker.

    Workers run the prepare closure on their own stream and wait for its
    device work (an event synchronize), so probe/warp kernels complete
    off the engine thread, beside the march on the engine's stream.
    Commits still happen only on the engine thread in admission order —
    ``take`` blocks until the worker finishes (or steals a still-queued
    closure inline), and Stage B revalidates the result, so worker
    scheduling can never reorder or alter commits.

    ``device`` is the card the engine renders on (its streams are made
    there); a CPU device runs the closures on the threads alone.

    ``max_concurrent`` bounds how many speculations EXECUTE at once
    (queued submissions wait on a semaphore, FIFO): the default leaves
    one core's worth of concurrency for the engine thread.
    """

    backend = "threaded"

    def __init__(self, workers: int, max_concurrent: Optional[int] = None,
                 device=None):
        super().__init__()
        if workers <= 0:
            raise ValueError(f"ThreadedExecutor needs workers > 0, got "
                             f"{workers}")
        self.workers = workers
        if max_concurrent is None:
            max_concurrent = min(workers,
                                 max(1, (os.cpu_count() or 2) - 1))
        self.max_concurrent = max_concurrent
        self.device = torch.device("cpu" if device is None else device)
        self._sem = threading.Semaphore(max_concurrent)
        self._local = threading.local()
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="serve-stage-a")

    def _stream(self) -> Optional[torch.cuda.Stream]:
        """This worker thread's own stream on the engine's card."""
        if self.device.type != "cuda":
            return None
        stream = getattr(self._local, "stream", None)
        if stream is None:
            stream = self._local.stream = torch.cuda.Stream(self.device)
        return stream

    def _run(self, fn: Callable):
        with self._sem:
            # recorded on the worker's own lane (thread name) — the
            # speculation that overlaps the in-flight march
            with trace_lib.span("executor.run", backend=self.backend):
                return _run_on_stream(self._stream(), fn)

    def _spawn(self, key, fn: Callable) -> Future:
        return self._pool.submit(self._run, fn)

    def close(self):
        super().close()
        self._pool.shutdown(wait=False)


class DeviceExecutor(_FutureExecutor):
    """Multi-device Stage-A execution: speculation on secondary devices.

    Placement rule: the pooled march owns the engine's card (``device``)
    — Stage-A closures run on the SECONDARY devices (``cuda:1`` .. by
    default), round-robin per submitted slot, each device backed by its
    own single-thread queue and a stream of its own, with that device
    current (``torch.cuda.device``) and named by ``placement()``, which
    the render engine's ``prepare`` reads: it probes, warps and lays out
    there with the fields' replica for that device, and copies what it
    reads from the engine's caches there first.  ``take`` waits on the
    worker's event and copies the result to ``device``, so Stage B and
    the march see only tensors on the engine's card; a copy or a replica
    that fails raises from ``take``, nothing falls back to the engine's
    card (``device`` None leaves results where they were made).  A CPU
    device runs closures on its thread alone.

    A stolen ``take`` (speculation still queued when the engine needs
    it) runs inline on the engine thread, unplaced, exactly like the sync
    backend — placement is best-effort under load, never a stall.
    """

    backend = "device"

    def __init__(self, devices: Optional[List] = None, device=None):
        super().__init__()
        if devices is None:
            devices = _available_devices()[1:]
        if not devices:
            raise ValueError("DeviceExecutor needs at least one device")
        self.devices = [torch.device(d) for d in devices]
        self.device = None if device is None else torch.device(device)
        self.workers = len(self.devices)
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in self.devices]
        self._pools = [
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix=f"serve-dev{i}")
            for i in range(len(self.devices))]
        self._rr = 0

    def _run(self, i: int, fn: Callable):
        dev = self.devices[i]
        # device attr records the PLACEMENT; the lane (serve-dev*)
        # records the per-device queue that executed it
        with trace_lib.span("executor.run", backend=self.backend,
                            device=str(dev)):
            _placed.device = dev
            try:
                if dev.type != "cuda":
                    return _run_on_stream(None, fn)
                with torch.cuda.device(dev):
                    return _run_on_stream(self._streams[i], fn)
            finally:
                _placed.device = None

    def _spawn(self, key, fn: Callable) -> Future:
        i = self._rr % len(self.devices)
        self._rr += 1
        return self._pools[i].submit(self._run, i, fn)

    def close(self):
        super().close()
        for pool in self._pools:
            pool.shutdown(wait=False)


def make_executor(workers: int, devices: int = 0, device=None):
    """The backend for a (workers, devices) config on the engine's
    ``device``.

    ``devices=n > 0`` asks for Stage-A placement on up to n secondary
    cards, handed back to ``device``.  A one-card host has no secondary
    card to place on, so the config gives the bit-identical SyncExecutor
    instead of failing — which still runs every closure on the engine's
    card, inline on the engine thread (nothing moves to the CPU).
    Otherwise ``workers=n > 0`` selects the ThreadedExecutor (n streams
    on ``device``); the default is synchronous.
    """
    if devices > 0:
        avail = _available_devices()
        if len(avail) > 1:
            return DeviceExecutor(avail[1:1 + devices], device=device)
        return SyncExecutor()
    return (ThreadedExecutor(workers, device=device) if workers > 0
            else SyncExecutor())


def block_until_ready(*tensors):
    """Wait until every (possibly-None, possibly-host) tensor is ready: a
    synchronize of the current stream of each card they lie on."""
    for dev in {t.device for t in tensors
                if t is not None and isinstance(t, torch.Tensor)
                and t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
