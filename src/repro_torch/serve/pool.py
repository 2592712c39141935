"""Block pooling layer: pad/sort layouts, batching, dedup
(``repro.serve.pool``).

Owns every device SHAPE decision of the serving pipeline:

  * ``build_layout`` — a request's rays padded to whole blocks and
    budget-sorted (``pipeline.pad_rays_to_blocks`` + ``block_sort``).
    Stage-A code: the admission layer calls it speculatively (prefetch /
    worker threads) keyed on the plan bases, so the Stage-B commit never
    performs pad/sort device work.
  * ``BlockPool`` — the per-``render()`` pool of undispatched blocks from
    all live slots: scene-store admission/sweep delivery, budget-sorted
    batch selection, in-batch key dedup, fixed-size batch padding, and
    the dispatch/collect split the engine overlaps Stage A with.

Invariant owned here: batches have a fixed block count
(``blocks_per_batch``); the trailing partial batch is padded with
unit-budget dummy blocks, and budget-descending selection keeps batches
budget-homogeneous.  On the card the padding buys no compile (nothing is
traced); it keeps ``pad_blocks``, ``pad_block_fraction`` and every
batch's contents equal to the reference's.  Selection is
deadline-PRIMARY (serve/scheduler.py request classes): an
earlier-deadline slot's blocks march before a later/no-deadline slot's,
budget-descending within — for default-class traffic (every deadline
inf) this reduces to the pure budget sort exactly.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from functools import partial
from typing import List, Optional

import numpy as np
import torch

from ..core import pipeline, scene
from ..device import resolve_device
from ..obs import trace as trace_lib
from ..scenecache import key as scenecache_key


def batched_march(fns, acfg, density_only: bool = False):
    """The (N, B)-block march of one (field, config, density flag):
    ``pipeline.march_blocks``, the backend seam, so a FieldFns carrying
    fused-march resources under ``march_backend="fused"`` runs each batch
    as ONE ``fused_march`` launch; everything else gets the chunked
    reference march.  ``density_only`` marches skip the color MLP
    entirely (rgb reads zero) — the cheap acc/depth refresh for rays
    whose radiance came from the warp/radiance tiers.

    The reference keeps an LRU of jitted executables here, shared across
    engines; eager torch compiles nothing per (field, config), so there
    is nothing to cache and the partial is built per call.
    """
    return partial(pipeline.march_blocks, fns, acfg,
                   density_only=density_only)


@dataclasses.dataclass
class BlockLayout:
    """A request's padded, budget-sorted block geometry plus its
    radiance-warp composition inputs — everything Stage B needs to build
    a slot without touching device shapes.

    ``rays`` are device tensors; ``order``/``budgets`` host numpy.
    ``march_idx`` selects the disoccluded rays the slot actually marches
    (None = all rays); ``base_rgb`` is the warped cached frame those rays
    composite over (host).  A full radiance hit has zero blocks and an
    empty ``march_idx``.
    """
    rays: tuple                  # padded (origins, dirs) of marched rays
    order: np.ndarray
    budgets: np.ndarray
    pad: int
    march_idx: Optional[np.ndarray] = None
    base_rgb: Optional[np.ndarray] = None
    valid_fraction: float = 0.0


def _scale_counts(counts, budget_scale: float):
    """Degrade per-ray sample counts to a budget tier: ceil(n * scale),
    floored at one sample.  Block budgets are per-block maxima of these
    counts (pipeline.block_sort), so scaling counts scales the chunk
    budgets of every downstream march — ASDR's adaptive-sampling knob
    repurposed as the scheduler's load-shedding actuator."""
    return torch.clamp(
        torch.ceil(counts.float() * budget_scale).to(counts.dtype), min=1)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def build_layout(acfg, cam, maps, warped, budget_scale: float = 1.0,
                 device=None) -> BlockLayout:
    """Pad + budget-sort one request's marched rays (Stage-A device work)
    on ``device`` (the GPU unless ``device="cpu"``).

    ``maps`` None means a full radiance hit: zero blocks, the frame is
    delivered entirely from ``warped``.  With a partial ``warped`` only
    the disoccluded rays enter the block layout.  ``budget_scale`` < 1
    is a degraded tier (serve/scheduler.py): per-ray counts scale BEFORE
    pad/sort, so budgets, block order, and scenecache keys (which
    include budgets) all see the degraded tier natively; 1.0 skips the
    scaling ops entirely.
    """
    march_idx = base_rgb = None
    vf = 0.0
    if warped is not None:
        march_idx = _host(torch.nonzero(~warped.valid).flatten())
        base_rgb = _host(warped.rgb)
        vf = warped.valid_fraction
    if maps is None:
        dev = resolve_device(device)
        rays = (torch.zeros((0, 3), device=dev),
                torch.zeros((0, 3), device=dev))
        order = np.zeros((0,), np.int64)
        budgets = np.zeros((0,), np.int64)
        pad = 0
    else:
        o, d = scene.camera_rays(cam, device=device)
        counts, opacity = maps.counts, maps.opacity
        if march_idx is not None:
            sel = torch.from_numpy(march_idx).to(o.device)
            o, d = o[sel], d[sel]
            counts, opacity = counts[sel], opacity[sel]
        if budget_scale != 1.0:
            counts = _scale_counts(counts, budget_scale)
        o, d, counts, opacity, pad = pipeline.pad_rays_to_blocks(
            acfg, o, d, counts, opacity)
        order_t, budgets_t = pipeline.block_sort(acfg, counts, opacity)
        rays = (o, d)
        order, budgets = _host(order_t), _host(budgets_t)
    return BlockLayout(rays, order, budgets, pad, march_idx, base_rgb, vf)


def build_density_layout(acfg, cam, maps, warped, budget_scale: float = 1.0,
                         device=None) -> Optional[BlockLayout]:
    """Pad + budget-sort the WARP-VALID rays of a partial radiance hit
    for a density-only refresh march (opt-in via
    ``RenderServeConfig.density_refresh``).

    These rays' rgb is served by the warp, but without acc/depth the
    warped frame can never re-enter the radiance cache ("warps never
    chain").  A density-only march (no color MLP — the fused kernel
    skips the color chain outright) recovers exact acc/depth for them,
    so the finalized frame becomes cacheable again.  ``march_idx`` here
    holds the VALID-ray image indices the density outputs scatter back
    to.  None when the warp left no valid rays (nothing to refresh).
    """
    valid_idx = _host(torch.nonzero(warped.valid).flatten())
    if valid_idx.size == 0:
        return None
    o, d = scene.camera_rays(cam, device=device)
    sel = torch.from_numpy(valid_idx).to(o.device)
    counts = maps.counts[sel]
    if budget_scale != 1.0:
        counts = _scale_counts(counts, budget_scale)
    o, d, counts, opacity, pad = pipeline.pad_rays_to_blocks(
        acfg, o[sel], d[sel], counts, maps.opacity[sel])
    order_t, budgets_t = pipeline.block_sort(acfg, counts, opacity)
    return BlockLayout((o, d), _host(order_t), _host(budgets_t), pad,
                       valid_idx)


class BlockPool:
    """The per-render() pool of undispatched blocks across live slots.

    Items are (slot, block_index, o, d, budget, key, cell, dens)
    tuples — o/d (B, 3) device tensors, key/cell None with the scene
    tier off, and the pooled-march path is then untouched by the store.
    ``dens`` marks a DENSITY-ONLY block (acc/depth refresh for
    warp-served rays): those never carry a scene key — their rgb-less
    outputs must not collide with color entries in the shared store.
    """

    def __init__(self, acfg, blocks_per_batch: int, scenecache, counters):
        self.acfg = acfg
        self.blocks_per_batch = blocks_per_batch
        self.scenecache = scenecache
        self.counters = counters
        self.items: List[tuple] = []
        self._batch_seq = 0          # trace batch ids, per render() call

    def __len__(self) -> int:
        return len(self.items)

    # ------------------------------------------------------------ admit
    def add_slot(self, slot):
        """Pool a freshly admitted slot's blocks.  Blocks already
        resident in the scene store deliver HERE (their one counted
        lookup) and never enter the pool.  The keys are computed on the
        host from one copy of the slot's sorted rays."""
        with trace_lib.span("pool.add_slot", req=slot.req.rid):
            self._add_slot(slot)

    def _add_slot(self, slot):
        o_s, d_s = slot.sorted_rays(*slot.rays)
        items = list(slot.emit_blocks(o_s, d_s))
        dens_items = [it + (None, None, True)
                      for it in slot.emit_density_blocks()]
        if self.scenecache is None or not items:
            self.items.extend(it + (None, None, False) for it in items)
            self.items.extend(dens_items)
            return
        with trace_lib.span("scenecache.keys", blocks=len(items)):
            kcs = scenecache_key.block_keys(
                self.scenecache.cfg, slot.req.scene, self.acfg, o_s, d_s,
                slot.budgets)
        for it, kc in zip(items, kcs):
            out = self.scenecache.lookup(kc[0])
            if out is None:
                self.items.append(it + kc + (False,))
            else:
                it[0].deliver(it[1], out.rgb, out.acc, out.depth,
                              out.chunks, cached=True)
                self.counters.scene_blocks_hit += 1
        self.items.extend(dens_items)

    def sweep(self):
        """Deliver every pooled block whose key BECAME resident; keep the
        rest.

        Runs once per scheduling round, so a block marched (and stored)
        for one request satisfies an identical block another client
        pooled in the SAME round — cross-request sharing without any
        inter-slot coordination.  Pool items already recorded their miss
        at admission, so these re-checks don't count misses (hits do).

        Against a store exposing ``fetch_async`` (scenecache/sharded.py)
        the re-checks fan out as one future per pooled block and are
        joined here before the round's dispatch.  Delivery order and
        semantics are identical to the synchronous path.
        """
        if self.scenecache is None or not self.items:
            return
        with trace_lib.span("pool.sweep", items=len(self.items)):
            fetch = getattr(self.scenecache, "fetch_async", None)
            if fetch is not None:
                futs = [fetch(it[5], count_miss=False)
                        if it[5] is not None else None
                        for it in self.items]
                with trace_lib.span(
                        "pool.fetch_join",
                        fetches=sum(f is not None for f in futs)):
                    self._join_and_deliver(futs)
                return
            outs = [self.scenecache.lookup(it[5], count_miss=False)
                    if it[5] is not None else None for it in self.items]
            rest = []
            for it, out in zip(self.items, outs):
                if self._deliver_swept(it, out):
                    rest.append(it)
            self.items = rest

    def _join_and_deliver(self, futs):
        """Join async shard fetches as they COMPLETE, delivering the done
        prefix immediately (delivery order itself stays exactly the
        submission order, so frames and counters are identical to the
        synchronous join)."""
        results: dict = {}
        owner = {f: i for i, f in enumerate(futs) if f is not None}
        rest, next_i = [], 0

        def drain(limit):
            nonlocal next_i
            while next_i < limit and (futs[next_i] is None
                                      or next_i in results):
                it = self.items[next_i]
                if self._deliver_swept(it, results.get(next_i)):
                    rest.append(it)
                next_i += 1

        for f in concurrent.futures.as_completed(owner):
            results[owner[f]] = f.result()
            drain(len(futs))
        drain(len(futs))
        self.items = rest

    def _deliver_swept(self, it, out) -> bool:
        """Deliver one swept lookup result; True = keep pooled."""
        if out is None:
            return True
        it[0].deliver(it[1], out.rgb, out.acc, out.depth,
                      out.chunks, cached=True)
        self.counters.scene_blocks_hit += 1
        return False

    # --------------------------------------------------------- dispatch
    def dispatch(self, march_for):
        """Single-batch round: the first handle of a ``dispatch_round``
        capped at one batch (or None, empty pool)."""
        handles = self.dispatch_round(march_for, 1)
        return handles[0] if handles else None

    def dispatch_round(self, march_for, max_batches: int = 1):
        """The STREAMING scheduler: assemble and DISPATCH up to
        ``max_batches`` batches (device-async) for one round; returns the
        in-flight handles for ``collect`` in dispatch order.

        Each batch is drawn from the pool's current largest-budget
        (scene, density-flag) group, so batches stay budget-homogeneous;
        when the head group runs out of blocks, the NEXT largest group
        fills the remaining dispatch slots.  All batches are launched
        before any is collected, so batch k+1's launch queues behind
        batch k's march on the card (the engine additionally overlaps
        Stage-A speculation with the whole in-flight round).
        ``march_for(scene_id, density_only)`` maps a group to its
        batched march.
        """
        handles = []
        with trace_lib.span("pool.dispatch_round",
                            pooled=len(self.items)):
            while self.items and len(handles) < max_batches:
                handles.append(self._dispatch_one(march_for))
        return handles

    def _dispatch_one(self, march_for):
        # deadline-primary, budget-descending within: a slot with an
        # earlier absolute deadline marches ALL its blocks before a
        # later/no-deadline slot's — without this, a shed-DEGRADED
        # request's scaled-down budgets would sort its blocks behind
        # every full-budget bulk block and the degrade would buy
        # nothing (priority inversion).  Default-class slots are all
        # (inf, -budget): the pure budget sort.
        self.items.sort(key=lambda it: (
            it[0].req.cls.deadline_at(it[0].req.arrival_s), -it[4]))
        head = self.items[0]
        group = (head[0].req.scene, head[7])
        batch = [it for it in self.items
                 if (it[0].req.scene, it[7]) == group][:self.blocks_per_batch]
        taken = set(map(id, batch))
        self.items = [it for it in self.items if id(it) not in taken]
        self._batch_seq += 1

        # in-batch dedup: identical keys selected together (two clients
        # admitted the same round) march once; followers receive the
        # leader's outputs
        followers: List[tuple] = []
        if self.scenecache is not None:
            uniq, seen = [], {}
            for it in batch:
                if it[5] is not None and it[5] in seen:
                    followers.append((it, seen[it[5]]))
                else:
                    if it[5] is not None:
                        seen[it[5]] = len(uniq)
                    uniq.append(it)
            batch = uniq

        bid = self._batch_seq
        with trace_lib.span("pool.dispatch", batch=bid, scene=group[0],
                            density=group[1], blocks=len(batch),
                            reqs=sorted({it[0].req.rid
                                         for it in batch})) as sp:
            B = self.acfg.block_size
            N = self.blocks_per_batch
            n_pad = N - len(batch)
            dev = batch[0][2].device
            o_b = torch.stack([it[2] for it in batch]
                              + [torch.zeros((B, 3), device=dev)] * n_pad)
            d_b = torch.stack(
                [it[3] for it in batch]
                + [torch.tensor([[0., 0., 1.]], device=dev).expand(B, 3)]
                * n_pad)
            budgets = torch.tensor([it[4] for it in batch] + [1] * n_pad,
                                   dtype=torch.int32, device=dev)
            # dispatch only — outputs are fetched in collect(), after the
            # engine has overlapped Stage-A speculation
            out = march_for(group[0], group[1])(o_b, d_b, budgets)
        # dispatch-span attrs dict + launch-end timestamp ride the handle:
        # collect() stamps ``device_ms`` (launch -> outputs on the host)
        # back onto the already-closed span, splitting its host wall time
        # into queue/assembly vs device execution at export.
        disp_attrs = getattr(sp, "attrs", None)
        return (batch, followers, n_pad, out, bid, disp_attrs,
                time.perf_counter())

    def collect(self, inflight):
        """Fetch a dispatched batch and deliver/store its outputs.

        The ``pool.collect`` span covers the fetch and the delivery; its
        child ``pool.fetch`` is the device fetch wait — one ``.cpu()``
        per output, where the host waits for the batch's march.  Its
        ``batch`` id matches the ``pool.dispatch`` span that launched
        it, so a frame's lineage chains admission -> dispatch ->
        collect; it carries the real blocks' ``budgets`` and marched
        ``chunks`` and the ``density`` flag, the work the march did."""
        batch, followers, n_pad, out, bid, disp_attrs, t_launch = inflight
        with trace_lib.span("pool.collect", batch=bid,
                            blocks=len(batch),
                            reqs=sorted({it[0].req.rid for it in batch})
                            ) as sp:
            with trace_lib.span("pool.fetch", batch=bid):
                rgb, acc, depth, chunks, ray_chunks = (a.cpu().numpy()
                                                       for a in out)
            if sp is not trace_lib.NULL_SPAN:
                sp.attrs.update(budgets=[int(it[4]) for it in batch],
                                chunks=chunks[:len(batch)].tolist(),
                                density=batch[0][7])
            if disp_attrs is not None:
                disp_attrs["device_ms"] = (time.perf_counter()
                                           - t_launch) * 1e3
            if self.acfg.per_ray_early_exit and batch:
                # sample work the per-ray exit skipped: rays that went
                # dead ride chunks - ray_chunks masked chunks each, at
                # chunk samples per ray per chunk (real blocks only)
                nb = len(batch)
                skipped = (chunks[:nb, None] - ray_chunks[:nb]).sum()
                self.counters.ray_exit_samples_skipped += (
                    int(skipped) * self.acfg.chunk)
            for i, it in enumerate(batch):
                if it[7]:
                    it[0].deliver_density(it[1], acc[i], depth[i],
                                          chunks[i])
                    continue
                it[0].deliver(it[1], rgb[i], acc[i], depth[i], chunks[i])
                if it[5] is not None:
                    self.scenecache.store(it[5], it[6], rgb[i], acc[i],
                                          depth[i], int(chunks[i]))
            for it, li in followers:
                it[0].deliver(it[1], rgb[li], acc[li], depth[li],
                              chunks[li], cached=True)
                self.counters.scene_blocks_hit += 1
        self.counters.batches += 1
        self.counters.blocks_marched += len(batch)
        self.counters.pad_blocks += n_pad
