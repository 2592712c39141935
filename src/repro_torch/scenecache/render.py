"""Block-level cached Phase II: ``render_adaptive`` with scene-space reuse
(``repro.scenecache.render``).

Drop-in for ``core.pipeline.render_adaptive`` (same inputs, same
(rgb, acc, stats) contract, stats gain ``scene_block_hits`` /
``scene_block_misses``): blocks whose key hits the shared store composite
directly from the cached outputs; only the missing blocks — deduplicated,
so two identical blocks in one call march once — go through the batched
march, and their outputs populate the store.

The reference marches the missed blocks with ``_march_block`` under
``lax.map``; the port marches them through its backend seam,
``pipeline.march_blocks``: on the reference backend the same chunked
``_march_block``, with ``march_backend="fused"`` one ``fused_march``
launch over the distinct missed blocks.  Both keep the reference's
property that the all-miss first call equals ``render_adaptive`` bit for
bit, and a later call marches each missed block as the full launch would:
the fused kernel gives each block the same result whatever other blocks
share the launch (``csrc/fused_march.cu``; a ``gpu`` test holds it).

With ``cache=None`` this delegates straight to ``render_adaptive``.  Keys
are derived on the host (numpy), the cache holds host copies; the
assembly of hits and marched blocks and the unsort stay on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import pipeline
from ..core.fields import FieldFns
from ..core.pipeline import ASDRConfig
from . import key as key_lib
from .store import SceneBlockCache


def render_adaptive_cached(fns: FieldFns, acfg: ASDRConfig, origins, dirs,
                           counts, opacity=None,
                           cache: SceneBlockCache | None = None,
                           scene_id: str = "scene"):
    """Sorted-block adaptive render with shared block reuse.

    origins/dirs: (R, 3) with R % block_size == 0 (pad upstream);
    returns (rgb (R,3), acc (R,), stats).
    """
    if cache is None:
        rgb, acc, stats = pipeline.render_adaptive(
            fns, acfg, origins, dirs, counts, opacity)
        stats = dict(stats)
        stats["samples_reused"] = 0
        stats["scene_block_hits"] = 0
        stats["scene_block_misses"] = int(counts.shape[0]) // acfg.block_size
        return rgb, acc, stats

    R = origins.shape[0]
    B = acfg.block_size
    dev = origins.device
    order, budgets = pipeline.block_sort(acfg, counts, opacity)
    order = order.long()
    o_s = origins[order].reshape(-1, B, 3)
    d_s = dirs[order].reshape(-1, B, 3)
    nb = budgets.shape[0]
    keycells = key_lib.block_keys(cache.cfg, scene_id, acfg, o_s, d_s,
                                  budgets)

    rgb_s = torch.zeros((nb, B, 3), device=dev)
    acc_s = torch.zeros((nb, B), device=dev)
    dep_s = torch.zeros((nb, B), device=dev)
    chunks = np.zeros((nb,), np.int64)
    miss, hit, hit_outs = [], [], []
    for i, (k, _cell) in enumerate(keycells):
        out = cache.lookup(k)
        if out is None:
            miss.append(i)
        else:
            hit.append(i)
            hit_outs.append(out)
            chunks[i] = out.chunks
    hit_chunks = int(chunks.sum())

    if hit:
        # one copy of the hits' host outputs to the device
        at = torch.tensor(hit, device=dev)
        for dst, name in ((rgb_s, "rgb"), (acc_s, "acc"), (dep_s, "depth")):
            dst[at] = torch.from_numpy(np.stack(
                [getattr(h, name) for h in hit_outs])).to(dev)

    if miss:
        # march each DISTINCT missing key once; duplicate blocks within
        # this call (two image regions quantizing identically) ride along
        leader_of = {}
        leaders = []
        for i in miss:
            k = keycells[i][0]
            if k not in leader_of:
                leader_of[k] = len(leaders)
                leaders.append(i)
        lead = torch.tensor(leaders, device=dev)
        rgb_m, acc_m, dep_m, ch_m, _rc_m = pipeline.march_blocks(
            fns, acfg, o_s[lead], d_s[lead], budgets[lead])
        rgb_h, acc_h = rgb_m.cpu().numpy(), acc_m.cpu().numpy()
        dep_h, ch_h = dep_m.cpu().numpy(), ch_m.cpu().numpy()
        for j, i in enumerate(leaders):
            k, cell = keycells[i]
            cache.store(k, cell, rgb_h[j], acc_h[j], dep_h[j], int(ch_h[j]))
        src = torch.tensor([leader_of[keycells[i][0]] for i in miss],
                           device=dev)
        at = torch.tensor(miss, device=dev)
        rgb_s[at], acc_s[at], dep_s[at] = rgb_m[src], acc_m[src], dep_m[src]
        chunks[miss] = ch_h[src.cpu().numpy()]

    inv = torch.zeros_like(order)
    inv[order] = torch.arange(R, device=dev)
    # stats mirror the reference's dict field for field, except samples
    # split by whether the compute actually ran: hits replay stored
    # outputs, so their chunks are REUSED, not processed
    stats = {
        "samples_processed": (int(chunks.sum()) - hit_chunks)
        * B * acfg.chunk,
        "samples_reused": hit_chunks * B * acfg.chunk,
        "baseline_samples": R * acfg.ns_full,
        "chunks_per_block": torch.from_numpy(chunks.astype(np.int32)).to(dev),
        "budgets": budgets,
        "term_depth": dep_s.reshape(R)[inv],
        "scene_block_hits": nb - len(miss),
        "scene_block_misses": len(miss),
    }
    return rgb_s.reshape(R, 3)[inv], acc_s.reshape(R)[inv], stats
