"""Shared skeleton for pose-keyed caches of per-pixel device maps
(``repro.framecache.base``).

ProbeCache (Phase-I maps) and RadianceCache (finished frames) share their
entire matching and retention policy; keeping it in one place locks their
semantics together — a change to, say, the focal tolerance or the score
normalization cannot silently apply to one tier and not the other.

Subclasses provide entry objects with ``cam`` / ``acfg`` / ``last_used``
attributes and an ``rcfg`` carrying ``max_angle_deg``, ``max_translation``
and ``max_entries``.  Host-side bookkeeping only (pure python, one lookup
per request); the maps themselves stay on device.

Thread-safety contract (a speculative executor may run plan/execute
stages on worker threads):

  * every MUTATION of cache state — counters, the entry list, and any
    entry field including its ``version`` stamp — happens under
    ``self.lock``, and only the committing thread commits;
  * plan stages acquire ``self.lock`` just long enough to match an entry
    and SNAPSHOT everything execution will read (array refs + version);
    execution then runs lock-free on the snapshot;
  * entries are rebased by field REASSIGNMENT (``entry.maps = new``,
    never in-place array mutation) with the version bump in the same
    critical section, so a snapshot taken under the lock can never be
    torn: its arrays and its version stamp always belong to the same
    rebase generation.
"""
from __future__ import annotations

import threading

import numpy as np

from ..core import adaptive


class PoseKeyedCache:
    def __init__(self, rcfg):
        self.rcfg = rcfg
        self._entries: list = []
        self._clock = 0
        self._seq = 0
        self.hits = 0
        self.misses = 0
        self.refreshes = 0
        # guards ALL mutation and the plan stages' entry-state snapshots
        # (see module docstring).  RLock: commit paths re-enter via _store.
        self.lock = threading.RLock()

    def __len__(self):
        return len(self._entries)

    def resident_bytes(self) -> int:
        """Total bytes held by cached maps/frames.

        Feeds the shared-budget accounting that covers all reuse tiers
        (the scene-space block tier bounds itself in bytes; these pose
        tiers report theirs so an operator can see the whole footprint).
        """
        return sum(self._entry_nbytes(e) for e in self._entries)

    @staticmethod
    def _arrays_nbytes(*arrays) -> int:
        return sum(getattr(a, "nbytes", 0) for a in arrays if a is not None)

    def _entry_nbytes(self, entry) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    @property
    def reused_fraction(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _match(self, cam, acfg):
        """Nearest usable entry: (entry, angle, translation) or None."""
        max_ang = np.deg2rad(self.rcfg.max_angle_deg)
        max_tr = self.rcfg.max_translation
        best, best_score = None, np.inf
        for e in self._entries:
            # image geometry and render config must match exactly: the maps
            # are per-pixel and acfg-specific; a different focal (zoom)
            # changes every ray even at an identical pose.  Filtering here
            # (not post-hoc) lets entries for different configs coexist
            # instead of shadowing each other.
            if e.acfg != acfg:
                continue
            if (e.cam.height, e.cam.width) != (cam.height, cam.width):
                continue
            if abs(e.cam.focal - cam.focal) > 1e-6 * max(cam.focal, 1.0):
                continue
            ang, tr = adaptive.pose_distance(cam, e.cam)
            if ang > max_ang or tr > max_tr:
                continue
            score = ang / max(max_ang, 1e-9) + tr / max(max_tr, 1e-9)
            if score < best_score:
                best, best_score = (e, ang, tr), score
        return best

    def _append_with_eviction(self, entry):
        """Add an entry, evicting the least-recently-used past capacity.

        Totally ordered: exact recency ties break by insertion sequence
        (oldest first), never by list position — rebased entries keep
        their slot in ``_entries``, so position is NOT insertion order
        and must not decide evictions.
        """
        entry.seq = self._seq
        self._seq += 1
        if len(self._entries) >= self.rcfg.max_entries:
            self._entries.remove(
                min(self._entries,
                    key=lambda e: (e.last_used, getattr(e, "seq", 0))))
        self._entries.append(entry)
