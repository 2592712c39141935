"""A shared, memory-bounded cache of finished Phase-II block outputs
(``repro.scenecache.store``).

One ``SceneBlockCache`` serves every user of a process: entries are keyed
by scene-space block identity (key.py), so N clients orbiting the same
scene share hits instead of each holding a private per-pose LRU — the
structural difference from the framecache tiers, whose entries are
per-pose full-resolution maps and whose memory grows with the number of
distinct trajectories.

Retention is governed by a single explicit **byte budget**, never an
entry count: ``resident_bytes() <= byte_budget`` holds after every
operation (an entry larger than the whole budget is rejected outright).
Eviction is **coverage-aware LRU**, totally ordered and deterministic:

  1. entries whose coarse coverage cell holds OTHER resident entries are
     redundant coverage of that scene region and evict first;
  2. within a group, least-recently-used evicts first;
  3. exact recency ties break by insertion sequence (oldest first).

No step consults dict iteration order beyond Python's guaranteed
insertion order, so two caches fed the same operation sequence always
hold the same entries (tests/test_torch_scenecache.py holds this against
the reference's store).

The victim comes from an index, not a scan: two heaps of
``(last_used, seq, key)``, one of redundant entries and one of entries
alone in their cell.  Every resident entry has exactly one live item,
the one its ``_Entry.item`` holds; a touch or a change of group files a
new item and leaves the old one stale, to be dropped when it reaches a
heap's top.  A cell's count crossing 1 <-> 2 moves exactly one other
entry between the groups, so a store, a hit or an eviction files O(1)
items, and the index is rebuilt whenever stale items outnumber live
ones.  A store costs O(log N) amortised in the N resident entries.

Outputs are stored as host numpy arrays (storage, not compute): the cache
bounds HOST memory and never pins device buffers; a hit costs one dict
lookup plus a copy into the consumer's block buffers on the device.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Optional, Set

import numpy as np

from ..obs import trace as trace_lib
from .key import host_array


@dataclasses.dataclass(frozen=True)
class SceneCacheConfig:
    """Quantization + budget knobs for the scene-space block tier.

    voxel_res / view_buckets set the key quantization (key.py): higher
    values mean stricter matching (identical-pose reuse only), lower
    values let nearby poses alias into shared keys at the cost of
    approximation error.  byte_budget is the hard cap on resident bytes.
    """
    voxel_res: int = 256
    view_buckets: int = 64
    coverage_res: int = 8
    byte_budget: int = 32 << 20


@dataclasses.dataclass
class BlockOutput:
    """One block's finished Phase-II products (host-side copies)."""
    rgb: np.ndarray      # (B, 3) float32
    acc: np.ndarray      # (B,)   float32
    depth: np.ndarray    # (B,)   float32 — march termination depth
    chunks: int          # while_loop trips the march actually ran

    @property
    def nbytes(self) -> int:
        # + key digest and python bookkeeping overhead, nominal
        return self.rgb.nbytes + self.acc.nbytes + self.depth.nbytes + 64


@dataclasses.dataclass
class _Entry:
    out: BlockOutput
    cell: tuple
    last_used: int
    seq: int
    item: tuple = None   # its live item in the eviction index


class SceneBlockCache:
    def __init__(self, cfg: SceneCacheConfig | None = None):
        self.cfg = cfg or SceneCacheConfig()
        self._entries: Dict[bytes, _Entry] = {}
        self._cells: Dict[tuple, Set[bytes]] = {}   # cell -> resident keys
        self._redundant: list = []   # heaps of (last_used, seq, key)
        self._sole: list = []
        self._bytes = 0
        self._clock = 0
        self._seq = 0
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.evictions = 0
        self.rejected = 0

    def __len__(self) -> int:
        return len(self._entries)

    def resident_bytes(self) -> int:
        return self._bytes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------------------------------------- lookup
    def lookup(self, key: bytes,
               count_miss: bool = True) -> Optional[BlockOutput]:
        """The cached output for a block key, or None (march + store).

        ``count_miss=False`` is for RE-checks of a key that already
        recorded its miss (the serving engine re-sweeps its pool every
        round): hits always count, but a block waiting k rounds must not
        count k misses, or ``stats()['hit_rate']`` deflates.
        """
        e = self._entries.get(key)
        if e is None:
            if count_miss:
                self.misses += 1
            return None
        self.hits += 1
        e.last_used = self._tick()
        self._file(key, e)
        self._compact()
        # hits only: a span per pool re-sweep miss would dominate the
        # trace; misses are visible as the marched blocks they become
        trace_lib.instant("scenecache.hit")
        return e.out

    # -------------------------------------------------------------- store
    def store(self, key: bytes, cell: tuple, rgb, acc, depth,
              chunks: int) -> bool:
        """Insert a marched block's outputs; False if it can never fit."""
        out = BlockOutput(*(np.ascontiguousarray(host_array(a), np.float32)
                            for a in (rgb, acc, depth)), int(chunks))
        if out.nbytes > self.cfg.byte_budget:
            self.rejected += 1
            return False
        with trace_lib.span("scenecache.store", bytes=out.nbytes) as sp:
            old = self._entries.pop(key, None)
            if old is not None:
                self._drop_bookkeeping(key, old)
            e = self._entries[key] = _Entry(out, cell, self._tick(), self._seq)
            self._seq += 1
            members = self._cells.setdefault(cell, set())
            members.add(key)
            if len(members) == 2:    # the cell's other entry turns redundant
                self._refile(members - {key})
            self._file(key, e)
            self._bytes += out.nbytes
            examined = 0
            while self._bytes > self.cfg.byte_budget:
                examined += self._evict_one()
            self._compact()
            self.stores += 1
            if sp is not trace_lib.NULL_SPAN:
                sp.attrs["examined"] = examined
        return True

    # ----------------------------------------------------------- eviction
    def _heap(self, e: _Entry) -> list:
        """The heap of ``e``'s eviction group."""
        return self._redundant if len(self._cells[e.cell]) > 1 else self._sole

    def _file(self, key: bytes, e: _Entry):
        """File ``e``'s item under its group and recency; the item it
        had goes stale."""
        e.item = (e.last_used, e.seq, key)
        heapq.heappush(self._heap(e), e.item)

    def _refile(self, keys):
        for k in keys:
            self._file(k, self._entries[k])

    def _compact(self):
        """Rebuild both heaps from the live items once stale ones
        outnumber them, so that touches (a pool re-swept every round
        re-touches its keys) cannot grow the index without bound."""
        if len(self._redundant) + len(self._sole) <= 2 * len(self._entries):
            return
        self._redundant, self._sole = [], []
        for key, e in self._entries.items():
            e.item = (e.last_used, e.seq, key)
            self._heap(e).append(e.item)
        heapq.heapify(self._redundant)
        heapq.heapify(self._sole)

    def _drop_bookkeeping(self, key: bytes, e: _Entry):
        members = self._cells[e.cell]
        members.discard(key)
        if len(members) == 1:        # the cell's last entry turns sole
            self._refile(members)
        elif not members:
            del self._cells[e.cell]
        self._bytes -= e.out.nbytes

    def _evict_one(self) -> int:
        """Evict exactly one entry by the coverage-aware LRU total order;
        returns the index items inspected, stale ones included.

        The key just stored is never the victim, with no test for it: it
        is the newest entry, so it would head its group only alone
        there.  It is never alone among the redundant (its cell holds
        an older one), and alone among the sole with no redundant entry
        it is the only entry, which fits the budget."""
        examined = 0
        for heap in (self._redundant, self._sole):
            while heap:
                item = heapq.heappop(heap)
                examined += 1
                e = self._entries.get(item[2])
                if e is not None and e.item is item:
                    del self._entries[item[2]]
                    self._drop_bookkeeping(item[2], e)
                    self.evictions += 1
                    trace_lib.instant("scenecache.evict", bytes=e.out.nbytes)
                    return examined

    # ------------------------------------------------------ serialization
    def dump_entry(self, key: bytes) -> Optional[bytes]:
        """The resident entry as a stable byte record (serial.py), or
        None if the key is not resident.  Does not count as a hit or
        touch recency — dumping is replication, not consumption."""
        e = self._entries.get(key)
        if e is None:
            return None
        from . import serial
        return serial.entry_to_bytes(key, e.cell, e.out)

    def load_entry(self, data: bytes) -> Optional[bytes]:
        """Insert a serialized entry (e.g. fetched from a peer shard);
        returns its key, or None if the entry can never fit this cache's
        byte budget (store's rejection — the caller must not assume the
        key is resident).  Goes through ``store`` so the byte budget and
        eviction order hold exactly as for a locally marched block."""
        from . import serial
        key, cell, out = serial.entry_from_bytes(data)
        stored = self.store(key, cell, out.rgb, out.acc, out.depth,
                            out.chunks)
        return key if stored else None

    def clear(self):
        """Drop everything — required after a scene's field is retrained
        or reloaded under the same id (keys carry the scene id, not the
        field's weights)."""
        self._entries.clear()
        self._cells.clear()
        self._redundant, self._sole = [], []
        self._bytes = 0

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "resident_bytes": self._bytes,
            "byte_budget": self.cfg.byte_budget,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "stores": self.stores,
            "evictions": self.evictions,
            "rejected": self.rejected,
        }
