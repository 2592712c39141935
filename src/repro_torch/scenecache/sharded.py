"""Sharded scene-block cache: N shard stores routed by key bytes
(``repro.scenecache.sharded``).

The scale-out form of ``SceneBlockCache`` (ROADMAP "distributed render
fleet"): several engine replicas serve one scene against one shared
store, so the store must (a) bound memory per shard, not just globally,
(b) admit concurrent access from many engine threads, and (c) tolerate
fetch latency — a shard in a real fleet is a network peer, not a dict.

Design:

  * **Routing** is a pure function of the key bytes alone —
    ``shard_of(key, n) = int.from_bytes(key[:8], 'little') % n``.  Keys
    are blake2b digests (key.py), so the low 8 bytes are uniform and the
    mapping is stable across processes, hosts, and Python hash
    randomization: every replica of a fleet computes the same shard for
    the same block without coordination (property-tested in
    tests/test_scenecache.py).
  * **Per-shard byte budgets**: the configured ``byte_budget`` splits
    evenly (floor) across shards; each shard is a full
    ``SceneBlockCache`` enforcing ``resident_bytes() <= budget // n``
    with its own coverage-aware deterministic LRU.  Total resident bytes
    therefore never exceed the configured budget, and one hot shard can
    never starve the others' coverage.
  * **Concurrency**: one lock per shard wraps every store/lookup — N
    replicas contend per shard, not on one global lock, which is the
    point of sharding a write-through cache.
  * **Async fetch**: ``fetch_async(key)`` resolves the lookup on a small
    fetch pool and returns a ``Future`` — the host-side stand-in for a
    remote shard RPC.  A caller fans out one fetch per block and joins
    them, so N outstanding shard fetches overlap instead of
    serializing.
  * **Replication** reuses the serial.py wire format per shard:
    ``dump_entry`` reads the owning shard, ``load_entry`` routes the
    record by its key (``serial.peek_entry_key``) and inserts through
    that shard's budgeted store path.

``ShardedSceneCache`` is interface-compatible with ``SceneBlockCache``
(lookup/store/dump_entry/load_entry/resident_bytes/stats/clear); at
``shards=1`` its observable semantics equal the plain store's.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import replace
from typing import List, Optional

from ..obs import trace as trace_lib
from . import serial
from .store import BlockOutput, SceneBlockCache, SceneCacheConfig


def shard_of(key: bytes, n_shards: int) -> int:
    """The shard index owning ``key`` — a pure function of the key bytes.

    Uses the little-endian integer of the first 8 digest bytes modulo
    the shard count: no Python ``hash()`` (randomized per process), no
    object identity — two processes always agree.
    """
    return int.from_bytes(key[:8], "little") % n_shards


class ShardedSceneCache:
    def __init__(self, cfg: Optional[SceneCacheConfig] = None,
                 shards: int = 4, fetch_workers: Optional[int] = None):
        assert shards >= 1
        self.cfg = cfg or SceneCacheConfig()
        self.n_shards = shards
        per_budget = self.cfg.byte_budget // shards
        self.shards: List[SceneBlockCache] = [
            SceneBlockCache(replace(self.cfg, byte_budget=per_budget))
            for _ in range(shards)]
        self._locks = [threading.Lock() for _ in range(shards)]
        self._fetch_pool = ThreadPoolExecutor(
            max_workers=fetch_workers or min(shards, 4),
            thread_name_prefix="scenecache-fetch")
        self._closed = False

    # ------------------------------------------------------------ routing
    def _shard(self, key: bytes) -> int:
        return shard_of(key, self.n_shards)

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    def resident_bytes(self) -> int:
        return sum(s.resident_bytes() for s in self.shards)

    # ----------------------------------------------------- lookup / store
    def lookup(self, key: bytes,
               count_miss: bool = True) -> Optional[BlockOutput]:
        i = self._shard(key)
        # the span covers lock wait + shard read: on the fetch pool its
        # lane is scenecache-fetch_*, the async-fetch side of the trace
        with trace_lib.span("scenecache.lookup", shard=i):
            with self._locks[i]:
                return self.shards[i].lookup(key, count_miss=count_miss)

    def fetch_async(self, key: bytes,
                    count_miss: bool = True) -> "Future[Optional[BlockOutput]]":
        """The lookup as a Future resolved on the fetch pool.

        A caller fans these out (one per block, hitting different shards
        concurrently) and joins them.  After ``close()`` falls
        back to an immediately-resolved inline lookup so draining
        callers never race the pool shutdown.
        """
        if self._closed:
            fut: Future = Future()
            fut.set_result(self.lookup(key, count_miss=count_miss))
            return fut
        return self._fetch_pool.submit(self.lookup, key,
                                       count_miss=count_miss)

    def store(self, key: bytes, cell: tuple, rgb, acc, depth,
              chunks: int) -> bool:
        i = self._shard(key)
        with trace_lib.span("scenecache.shard_store", shard=i):
            with self._locks[i]:
                return self.shards[i].store(key, cell, rgb, acc, depth,
                                            chunks)

    # ------------------------------------------------------- replication
    def dump_entry(self, key: bytes) -> Optional[bytes]:
        """The owning shard's resident entry as a serial.py record."""
        i = self._shard(key)
        with self._locks[i]:
            return self.shards[i].dump_entry(key)

    def load_entry(self, data: bytes) -> Optional[bytes]:
        """Insert a wire record into the shard its KEY routes to — the
        record's own bytes decide placement, so replicated entries land
        on the same shard everywhere.  Returns the key, or None if the
        owning shard's budget can never fit the entry."""
        i = self._shard(serial.peek_entry_key(data))
        with self._locks[i]:
            return self.shards[i].load_entry(data)

    def clear(self):
        for lock, s in zip(self._locks, self.shards):
            with lock:
                s.clear()

    def close(self):
        """Shut down the fetch pool (idempotent).  The stores stay
        readable — only the async path degrades to inline lookups."""
        self._closed = True
        self._fetch_pool.shutdown(wait=False)

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Shard-union stats: the same keys as ``SceneBlockCache.stats``
        with counters summed (at shards=1 the dicts agree except for the
        extra shard fields — property-tested), plus per-shard residency
        so a skewed shard is visible."""
        per = [s.stats() for s in self.shards]
        hits = sum(p["hits"] for p in per)
        misses = sum(p["misses"] for p in per)
        total = hits + misses
        return {
            "entries": sum(p["entries"] for p in per),
            "resident_bytes": sum(p["resident_bytes"] for p in per),
            "byte_budget": self.cfg.byte_budget,
            "hits": hits,
            "misses": misses,
            "hit_rate": hits / total if total else 0.0,
            "stores": sum(p["stores"] for p in per),
            "evictions": sum(p["evictions"] for p in per),
            "rejected": sum(p["rejected"] for p in per),
            "shards": self.n_shards,
            "per_shard_budget": self.cfg.byte_budget // self.n_shards,
            "per_shard_resident_bytes": [p["resident_bytes"] for p in per],
            "per_shard_entries": [p["entries"] for p in per],
        }
