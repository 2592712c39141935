"""Scene-space block reuse: a shared, memory-bounded cache of Phase-II
block outputs keyed by (voxel footprint, view bucket)
(``repro.scenecache``).

The fourth reuse tier (framecache/ holds the other three).  The
framecache tiers replay ONE user's trajectory cheaply — their entries
are per-pose full-resolution maps, so memory grows with distinct poses
and hits never cross users.  This tier caches at the granularity the compute actually
happens — the Phase-II block march — under a scene-space key, behind one
store with an explicit byte budget, so N concurrent users of one scene
share hits and bounded memory.

  key.py    — block key derivation (quantized voxel footprint + view
              bucket) and the coarse coverage cell;
  store.py  — SceneBlockCache: byte-budgeted, coverage-aware
              deterministic LRU;
  render.py — render_adaptive_cached, the single-image consumer
              (framecache/render.py);
  serial.py — stable to_bytes/from_bytes layouts for keys and entries —
              the wire format an external/sharded multi-host store
              exchanges (keys are stable digests, so they shard);
  sharded.py— ShardedSceneCache: N shard stores routed by key bytes,
              per-shard byte budgets + locks, async fetch futures.
"""
from .key import acfg_token, block_keys  # noqa: F401
from .render import render_adaptive_cached  # noqa: F401
from .serial import (entry_from_bytes, entry_to_bytes,  # noqa: F401
                     key_from_bytes, key_to_bytes, peek_entry_key)
from .sharded import ShardedSceneCache, shard_of  # noqa: F401
from .store import (BlockOutput, SceneBlockCache,  # noqa: F401
                    SceneCacheConfig)
