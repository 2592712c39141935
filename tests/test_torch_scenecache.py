"""Port parity: the scene-space block tier (scenecache/) against the JAX
reference's.

Block keys and serialised records byte for byte in both directions, the
store's hit / miss / eviction sequence and stats under one byte budget
(short and 3,000-op sequences, the eviction order's edges) and the work
its eviction index does,
shard routing; ``render_adaptive_cached``'s all-miss call bit-equal to the
port's ``render_adaptive`` and, against the reference's, rgb / acc / depth
within rtol 1e-4 / atol 1e-5 with chunks, budgets, hits and misses exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import scenecache as jsc_
from repro.core import fields as jfields
from repro.core import pipeline as jpl
from repro.core import scene as jsc
from repro_torch import obs as tobs
from repro_torch import scenecache as tsc_
from repro_torch.core import fields as tfields
from repro_torch.core import pipeline as tpl
from repro_torch.core import scene as tsc
from repro_torch.framecache import make_frame_cache

ACFG = dict(ns_full=48, probe_stride=4, candidates=(8, 16, 32), block_size=64,
            chunk=16)
SIZE = 24
RTOL, ATOL = 1e-4, 1e-5


def _blocks(rng, n=3, B=8):
    o = rng.uniform(0.2, 0.8, size=(n, B, 3)).astype(np.float32)
    d = rng.normal(size=(n, B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _out(rng, B):
    return (rng.uniform(size=(B, 3)).astype(np.float32),
            rng.uniform(size=(B,)).astype(np.float32),
            rng.uniform(tsc.NEAR, tsc.FAR, size=(B,)).astype(np.float32))


# ------------------------------------------------------------------ keys
@pytest.mark.parametrize("acfg_kw", [
    {}, ACFG, dict(ACFG, sort_by_opacity=True, delta=0.01),
    dict(ACFG, march_backend="fused", per_ray_early_exit=True)])
def test_acfg_token_equal(acfg_kw):
    """The port's ASDRConfig has the reference's fields in its order, so
    its repr, and so every block key, is the reference's."""
    assert (tsc_.acfg_token(tpl.ASDRConfig(**acfg_kw))
            == jsc_.acfg_token(jpl.ASDRConfig(**acfg_kw)))


@pytest.mark.parametrize("cfg_kw", [{}, dict(voxel_res=4, view_buckets=8),
                                    dict(coverage_res=2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_block_keys_byte_identical(cfg_kw, seed):
    """The same arrays through both packages: equal digests and cells,
    from numpy and from torch tensors."""
    rng = np.random.default_rng(seed)
    o, d = _blocks(rng, n=5)
    bud = rng.choice(np.array([8, 16, 32, 48]), 5)
    want = jsc_.block_keys(jsc_.SceneCacheConfig(**cfg_kw), "mic",
                           jpl.ASDRConfig(**ACFG), o, d, bud)
    cfg = tsc_.SceneCacheConfig(**cfg_kw)
    acfg = tpl.ASDRConfig(**ACFG)
    assert tsc_.block_keys(cfg, "mic", acfg, o, d, bud) == want
    assert tsc_.block_keys(cfg, "mic", acfg, torch.from_numpy(o),
                           torch.from_numpy(d),
                           torch.from_numpy(bud.astype(np.int32))) == want


def test_block_keys_of_a_frame_byte_identical():
    """A frame's sorted blocks (rays and budgets from each package's own
    Phase I) key identically."""
    acfg_j, acfg_t = jpl.ASDRConfig(**ACFG), tpl.ASDRConfig(**ACFG)
    jcam = jsc.look_at_camera(SIZE, SIZE, theta=0.7, phi=0.5)
    tcam = tsc.look_at_camera(SIZE, SIZE, theta=0.7, phi=0.5)
    fj = jfields.analytic_field_fns(jsc.make_scene("mic"))
    ft = tfields.analytic_field_fns(tsc.make_scene("mic"))
    keys = []
    for pl, sc, fns, acfg, cam, kw, mod in (
            (jpl, jsc, fj, acfg_j, jcam, {}, jsc_),
            (tpl, tsc, ft, acfg_t, tcam, {"device": "cpu"}, tsc_)):
        counts, _ = pl.probe_phase(fns, acfg, cam, **kw)
        o, d = sc.camera_rays(cam, **kw)
        order, bud = pl.block_sort(acfg, counts)
        B = acfg.block_size
        keys.append(mod.block_keys(mod.SceneCacheConfig(), "mic", acfg,
                                   o[order].reshape(-1, B, 3),
                                   d[order].reshape(-1, B, 3), bud))
    assert keys[0] == keys[1]


# ----------------------------------------------------------------- store
def _ops(seed, n_ops=80):
    rng = np.random.default_rng(seed)
    keys = [rng.bytes(16) for _ in range(7)]
    ops = []
    for _ in range(n_ops):
        k = keys[rng.integers(0, len(keys))]
        if rng.integers(0, 3) == 2:
            ops.append(("lookup", k))
        else:
            ops.append(("store", k, ("s", int(rng.integers(0, 3))),
                        _out(rng, 16), int(rng.integers(1, 4))))
    return ops


def _replay(mod, cache, ops):
    """Per op: the lookup's result, the store's or load's return or
    None for a clear, the resident keys in order, and the stats."""
    trace = []
    for op in ops:
        if op[0] == "lookup":
            out = cache.lookup(op[1])
            r = None if out is None else (out.rgb.tobytes(), out.chunks)
        elif op[0] == "clear":
            r = cache.clear()
        elif op[0] == "load":
            r = cache.load_entry(op[1])
        else:
            r = cache.store(op[1], op[2], *op[3], op[4])
        keys = (list(cache._entries) if hasattr(cache, "_entries")
                else [list(s._entries) for s in cache.shards])
        trace.append((r, keys, cache.stats()))
    return trace


@settings(max_examples=5, deadline=None)
@given(st.integers(min_value=0, max_value=10_000))
def test_store_sequence_identical(seed):
    """One op sequence under a budget of ~3.5 entries: every lookup's
    result, the resident keys after each op (coverage-aware LRU) and the
    stats equal the reference store's."""
    ops = _ops(seed)
    nbytes = tsc_.BlockOutput(*_out(np.random.default_rng(0), 16), 0).nbytes
    budget = int(nbytes * 3.5)
    got = _replay(tsc_, tsc_.SceneBlockCache(
        tsc_.SceneCacheConfig(byte_budget=budget)), ops)
    want = _replay(jsc_, jsc_.SceneBlockCache(
        jsc_.SceneCacheConfig(byte_budget=budget)), ops)
    assert got == want
    assert got[-1][2]["evictions"] > 0


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_sequence_identical(shards):
    ops = _ops(shards)
    nbytes = tsc_.BlockOutput(*_out(np.random.default_rng(0), 16), 0).nbytes
    budget = int(nbytes * 3.5) * shards
    t = tsc_.ShardedSceneCache(tsc_.SceneCacheConfig(byte_budget=budget),
                               shards=shards)
    j = jsc_.ShardedSceneCache(jsc_.SceneCacheConfig(byte_budget=budget),
                               shards=shards)
    try:
        assert _replay(tsc_, t, ops) == _replay(jsc_, j, ops)
        for op in ops[:8]:
            assert ((t.fetch_async(op[1]).result(timeout=30) is None)
                    == (j.fetch_async(op[1]).result(timeout=30) is None))
        assert t.stats() == j.stats()
    finally:
        t.close()
        j.close()


def _long_ops(seed, n_cells, n_ops=3000):
    """~3,000 ops over 600 keys, a third of them lookups, in three
    phases: stores into ``n_cells`` cells (about six resident entries a
    cell under a 300-entry budget, so evictions take the redundant and
    cells keep crossing 1 <-> 2), then stores into fresh cells (the
    redundant run out and the sole evict), then ``n_cells`` again."""
    rng = np.random.default_rng(seed)
    keys = [rng.bytes(16) for _ in range(600)]
    out = _out(rng, 16)
    ops = []
    for i in range(n_ops):
        k = keys[rng.integers(0, len(keys))]
        if rng.integers(0, 3) == 2:
            ops.append(("lookup", k))
            continue
        wide = n_ops // 3 <= i < 2 * n_ops // 3
        cell = ("s", int(rng.integers(n_cells, 100_000) if wide
                         else rng.integers(0, n_cells)))
        ops.append(("store", k, cell, out, int(rng.integers(1, 4))))
    return ops


@pytest.mark.parametrize("shards", [0, 2])
@pytest.mark.parametrize("seed,n_cells", [(0, 40), (1, 50), (2, 60), (3, 50)])
def test_store_sequence_identical_at_scale(seed, n_cells, shards):
    """The indexed eviction picks the reference scan's victim: 3,000 ops
    under a 300-entry budget give every lookup's result, the resident
    keys in order and the stats of the reference store after each op,
    through a plain store (``shards`` 0) and a two-shard one."""
    ops = _long_ops(seed, n_cells)
    nbytes = tsc_.BlockOutput(*_out(np.random.default_rng(0), 16), 0).nbytes
    caches = []
    for mod in (tsc_, jsc_):
        cfg = mod.SceneCacheConfig(byte_budget=300 * nbytes)
        caches.append(mod.ShardedSceneCache(cfg, shards=shards) if shards
                      else mod.SceneBlockCache(cfg))
    try:
        got, want = (_replay(mod, c, ops) for mod, c in zip((tsc_, jsc_),
                                                             caches))
        assert got == want
    finally:
        for c in caches:
            if shards:
                c.close()
    st = got[-1][2]
    assert st["evictions"] > 500 and st["hits"] > 100


def _edge_ops():
    """Op sequences under a budget of four 16-ray entries, each with the
    resident keys it must end with."""
    rng = np.random.default_rng(11)
    small, big, huge = _out(rng, 16), _out(rng, 64), _out(rng, 128)
    k = [bytes([i]) * 16 for i in range(10)]

    def put(i, cell, out=small):
        return ("store", k[i], ("s", cell), out, 2)

    record = tsc_.entry_to_bytes(k[9], ("s", 0),
                                 tsc_.BlockOutput(*small, 3))
    return {
        # k4 is stored as the sole group's one entry and a redundant one
        # goes; k8 is stored beside k3, the only other of its group, which goes
        "stored_key_alone_in_its_group": (
            [put(0, 0), put(1, 0), put(2, 0), put(3, 0), put(4, 1),
             put(5, 2), put(6, 2), put(7, 3), put(8, 0)],
            [4, 6, 7, 8]),
        "larger_than_the_budget": (
            [put(0, 0), put(1, 0, huge), ("lookup", k[1]), put(2, 1)],
            [0, 2]),
        "several_evictions_in_one_store": (
            [put(0, 0), put(1, 0), put(2, 1), put(3, 2), put(4, 3, big)],
            [4]),
        "clear_then_stores": (
            [put(0, 0), put(1, 0), put(2, 1), put(3, 1), put(4, 2),
             ("clear",), ("lookup", k[0]), put(5, 0), put(0, 0),
             put(6, 1), put(7, 2), put(8, 2)],
            [0, 6, 7, 8]),
        "load_of_a_dumped_record": (
            [put(0, 0), put(1, 0), put(2, 1), put(3, 2), ("load", record),
             ("lookup", k[9]), put(9, 3), ("load", record)],
            [1, 2, 3, 9]),
        "hit_just_before_an_eviction": (
            [put(0, 0), put(1, 0), put(2, 0), put(3, 0), ("lookup", k[0]),
             put(4, 0), ("lookup", k[2]), put(5, 0)],
            [0, 2, 4, 5]),
    }


@pytest.mark.parametrize("case", sorted(_edge_ops()))
def test_store_edge_cases(case):
    """Each edge of the eviction order against the reference store, op by
    op, and the resident keys it must end with."""
    ops, keep = _edge_ops()[case]
    nbytes = tsc_.BlockOutput(*_out(np.random.default_rng(0), 16), 0).nbytes
    got, want = (_replay(mod, mod.SceneBlockCache(
        mod.SceneCacheConfig(byte_budget=4 * nbytes)), ops)
        for mod in (tsc_, jsc_))
    assert got == want
    assert got[-1][1] == [bytes([i]) * 16 for i in keep]


def test_store_eviction_work_is_bounded():
    """3,000 resident entries, then 2,000 stores that each evict, with
    lookups between: the ``scenecache.store`` spans' ``examined`` (index
    items an eviction inspected, stale ones included) stays small on
    average, and the index never holds more than twice the entries."""
    rng = np.random.default_rng(7)
    out = _out(rng, 16)
    nbytes = tsc_.BlockOutput(*out, 0).nbytes
    cache = tsc_.SceneBlockCache(
        tsc_.SceneCacheConfig(byte_budget=3000 * nbytes))
    keys = [rng.bytes(16) for _ in range(5000)]
    cells = [("s", int(c)) for c in rng.integers(0, 500, len(keys))]
    for i in range(3000):
        cache.store(keys[i], cells[i], *out, 1)
    tr = tobs.Tracer()
    tobs.install(tr)
    try:
        for i in range(3000, 5000):
            cache.store(keys[i], cells[i], *out, 1)
            for j in rng.integers(i - 3000, i, 3):
                cache.lookup(keys[j])
            assert len(cache._redundant) + len(cache._sole) <= 2 * len(cache)
    finally:
        tobs.uninstall(tr)
    tr.drain()
    examined = [s.attrs["examined"] for s in tr.spans
                if s.name == "scenecache.store"]
    assert len(examined) == 2000 and cache.evictions == 2000
    assert cache.hits > 3000
    assert np.mean(examined) <= 8


@settings(max_examples=8, deadline=None)
@given(st.integers(min_value=0, max_value=2 ** 32), st.integers(1, 9))
def test_shard_of_identical(seed, n):
    key = np.random.default_rng(seed).bytes(16)
    assert tsc_.shard_of(key, n) == jsc_.shard_of(key, n)


def test_store_keeps_host_copies_of_tensors():
    """A store of torch tensors keeps float32 host copies, as the
    reference's of jax arrays."""
    rng = np.random.default_rng(5)
    rgb, acc, dep = _out(rng, 8)
    cache = tsc_.SceneBlockCache()
    cache.store(b"k", ("s", 0), torch.from_numpy(rgb), torch.from_numpy(acc),
                torch.from_numpy(dep.astype(np.float64)), 2)
    out = cache.lookup(b"k")
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float32
               for a in (out.rgb, out.acc, out.depth))
    np.testing.assert_array_equal(out.rgb, rgb)
    np.testing.assert_array_equal(out.depth, dep)


# ---------------------------------------------------------------- serial
@pytest.mark.parametrize("B", [4, 64])
def test_serial_cross_load_both_ways(B):
    """Records written by either package are the same bytes and load in
    the other; a dump after a cross-load gives the bytes back."""
    rng = np.random.default_rng(B)
    o, d = _blocks(rng, n=1, B=B)
    (key, cell), = jsc_.block_keys(jsc_.SceneCacheConfig(), "lego",
                                   jpl.ASDRConfig(**ACFG), o, d,
                                   np.asarray([24]))
    rgb, acc, dep = _out(rng, B)
    assert (tsc_.key_to_bytes(key, cell) == jsc_.key_to_bytes(key, cell))
    for src_mod, dst_mod in ((jsc_, tsc_), (tsc_, jsc_)):
        src = src_mod.SceneBlockCache()
        src.store(key, cell, rgb, acc, dep, 3)
        data = src.dump_entry(key)
        assert data == dst_mod.entry_to_bytes(
            key, cell, dst_mod.BlockOutput(rgb, acc, dep, 3))
        dst = dst_mod.SceneBlockCache()
        assert dst.load_entry(data) == key
        assert dst.dump_entry(key) == data
        assert dst_mod.peek_entry_key(data) == key
        k2, c2 = dst_mod.key_from_bytes(src_mod.key_to_bytes(key, cell))
        assert (k2, c2) == (key, cell)


def test_serial_rejects_foreign_records():
    rng = np.random.default_rng(6)
    o, d = _blocks(rng, n=1)
    (key, cell), = tsc_.block_keys(tsc_.SceneCacheConfig(), "mic",
                                   tpl.ASDRConfig(), o, d, np.asarray([8]))
    buf = tsc_.key_to_bytes(key, cell)
    ent = tsc_.entry_to_bytes(key, cell, tsc_.BlockOutput(
        *(np.zeros(s, np.float32) for s in ((4, 3), (4,), (4,))), 1))
    for bad in (b"XXXX" + buf[4:], buf + b"\x00", buf[:len(buf) // 2]):
        with pytest.raises(ValueError):
            tsc_.key_from_bytes(bad)
    for bad in (buf, ent[:len(ent) // 2], ent + b"\x00"):
        with pytest.raises(ValueError):
            tsc_.entry_from_bytes(bad)


# ------------------------------------------------------------ Phase II
def _rays(counts_np):
    jcam = jsc.look_at_camera(SIZE, SIZE, theta=0.7, phi=0.5)
    tcam = tsc.look_at_camera(SIZE, SIZE, theta=0.7, phi=0.5)
    return (jsc.camera_rays(jcam), tsc.camera_rays(tcam, device="cpu"),
            jnp.asarray(counts_np), torch.from_numpy(counts_np))


@pytest.mark.parametrize("scene_name", ["mic", "lego"])
def test_render_adaptive_cached_matches(scene_name):
    """All-miss call: bit-equal to the port's render_adaptive, and within
    the contract of the reference's render_adaptive_cached (chunks,
    budgets, hits and misses exact); the second call hits every block and
    gives the same frame; cache=None is render_adaptive."""
    rng = np.random.default_rng(7)
    counts = rng.choice(np.array([8, 16, 32, 48], np.int32), SIZE * SIZE)
    (jo, jd), (to, td), jc, tc = _rays(counts)
    acfg_j, acfg_t = jpl.ASDRConfig(**ACFG), tpl.ASDRConfig(**ACFG)
    fj = jfields.analytic_field_fns(jsc.make_scene(scene_name))
    ft = tfields.analytic_field_fns(tsc.make_scene(scene_name))
    jcache, tcache = jsc_.SceneBlockCache(), tsc_.SceneBlockCache()

    ref = tpl.render_adaptive(ft, acfg_t, to, td, tc)
    for call in range(2):
        jr = jsc_.render_adaptive_cached(fj, acfg_j, jo, jd, jc, None,
                                         jcache, scene_name)
        tr = tsc_.render_adaptive_cached(ft, acfg_t, to, td, tc, None,
                                         tcache, scene_name)
        for a, b in zip(tr[:2], ref[:2]):
            assert torch.equal(a, b)
        assert torch.equal(tr[2]["term_depth"], ref[2]["term_depth"])
        for a, b in zip(tr[:2] + (tr[2]["term_depth"],),
                        jr[:2] + (jr[2]["term_depth"],)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
        for k in ("chunks_per_block", "budgets"):
            np.testing.assert_array_equal(tr[2][k].numpy(),
                                          np.asarray(jr[2][k]))
        for k in ("samples_processed", "samples_reused", "baseline_samples",
                  "scene_block_hits", "scene_block_misses"):
            assert tr[2][k] == jr[2][k], k
        nb = SIZE * SIZE // ACFG["block_size"]
        assert tr[2]["scene_block_hits"] == (nb if call else 0)
    assert tcache.stats() == jcache.stats()
    none = tsc_.render_adaptive_cached(ft, acfg_t, to, td, tc)
    assert torch.equal(none[0], ref[0]) and none[2]["scene_block_hits"] == 0


def test_fused_backend_marches_through_the_seam():
    """march_backend="fused" on a field without fused resources takes the
    reference march, so the cached call stays bit-equal."""
    counts = np.full(SIZE * SIZE, 16, np.int32)
    _, (to, td), _, tc = _rays(counts)
    ft = tfields.analytic_field_fns(tsc.make_scene("mic"))
    acfg = tpl.ASDRConfig(**dict(ACFG, march_backend="fused"))
    rgb, _, st_ = tsc_.render_adaptive_cached(
        ft, acfg, to, td, tc, None, tsc_.SceneBlockCache(), "mic")
    assert torch.equal(rgb, tpl.render_adaptive(ft, acfg, to, td, tc)[0])
    assert st_["scene_block_misses"] == SIZE * SIZE // ACFG["block_size"]


def test_make_frame_cache_shared_store_requires_scene_id():
    store = tsc_.SceneBlockCache()
    with pytest.raises(ValueError, match="scene_id"):
        make_frame_cache(scene_cache=store)
    fc = make_frame_cache(scene_cache=store, scene_id="mic")
    assert fc.scene is store and fc.scene_id == "mic"


def test_duplicate_keys_march_once():
    """Two identical blocks in one call share one march and one store."""
    o, d = _blocks(np.random.default_rng(8), n=1, B=ACFG["block_size"])
    o = torch.from_numpy(np.concatenate([o, o]).reshape(-1, 3))
    d = torch.from_numpy(np.concatenate([d, d]).reshape(-1, 3))
    ft = tfields.analytic_field_fns(tsc.make_scene("mic"))
    cache = tsc_.SceneBlockCache()
    counts = torch.full((o.shape[0],), 16, dtype=torch.int32)
    acfg = tpl.ASDRConfig(**ACFG)
    rgb, _, st_ = tsc_.render_adaptive_cached(ft, acfg, o, d, counts, None,
                                              cache, "mic")
    assert st_["scene_block_misses"] == 2 and cache.stores == 1
    B = ACFG["block_size"]
    assert torch.equal(rgb[:B], rgb[B:])


# ----------------------------------------------------------------- engine
def test_engine_scenecache_none_is_bit_identical():
    """scenecache=None leaves the pooled-march engine bit-identical to
    render_asdr_image, and engine_stats has no store section."""
    from test_torch_render_serve import acfgs, field_pairs, requests
    from repro_torch.serve import render_engine as tre
    fns = field_pairs()["mic"][1]
    eng = tre.RenderServingEngine({"mic": fns}, acfgs()[1],
                                  tre.RenderServeConfig(
                                      slots=2, blocks_per_batch=4,
                                      reuse=None, scenecache=None),
                                  device="cpu")
    req = requests([(0, "mic", 0.7, 0.5)])[1]
    done = eng.render(req)
    ref, _ = tpl.render_asdr_image(fns, acfgs()[1], req[0].cam, device="cpu")
    np.testing.assert_array_equal(done[0].image, ref.numpy())
    assert "scenecache" not in eng.engine_stats()


def test_engine_cross_client_block_reuse_matches_reference():
    """Two clients at the same pose share one store: the second's blocks
    all come from it (no new marches), its frame equals the first's bit
    for bit, a third client on a SECOND engine over the same store too —
    and each engine's frames, hits and store stats equal the reference
    engines' over a reference store."""
    from test_torch_render_serve import (acfgs, assert_parity, field_pairs,
                                         requests, serve_cfgs)
    from repro.serve import render_engine as jre
    from repro_torch.serve import render_engine as tre
    flds = field_pairs()
    stores = (jsc_.SceneBlockCache(jsc_.SceneCacheConfig(byte_budget=8 << 20)),
              tsc_.SceneBlockCache(tsc_.SceneCacheConfig(byte_budget=8 << 20)))
    cfgs = serve_cfgs(slots=2, blocks_per_batch=4, reuse=None)
    acfg_j, acfg_t = acfgs()
    out = []
    for side, (re_, acfg, kw) in enumerate(((jre, acfg_j, {}),
                                            (tre, acfg_t, {"device": "cpu"}))):
        eng = re_.RenderServingEngine({"mic": flds["mic"][side]}, acfg,
                                      cfgs[side], scenecache=stores[side],
                                      **kw)
        reqs = [requests([(i, "mic", 0.7, 0.5)])[side] for i in range(2)]
        first, second = eng.render(reqs[0]), None
        marched = eng.blocks_marched
        second = eng.render(reqs[1])
        assert eng.blocks_marched == marched
        assert eng.scene_blocks_hit == 9
        assert second[0].stats["scene_block_hits"] == 9
        assert second[0].stats["samples_processed"] == 0
        assert (second[0].stats["samples_reused"]
                == first[0].stats["samples_processed"])
        np.testing.assert_array_equal(np.asarray(first[0].image),
                                      np.asarray(second[0].image))
        eng2 = re_.RenderServingEngine({"mic": flds["mic"][side]}, acfg,
                                       cfgs[side], scenecache=stores[side],
                                       **kw)
        third = eng2.render(requests([(2, "mic", 0.7, 0.5)])[side])
        assert eng2.blocks_marched == 0 and eng2.scene_blocks_hit == 9
        out.append((first + second + third, eng.engine_stats()))
        eng.close()
        eng2.close()
    (done_j, st_j), (done_t, st_t) = out
    assert_parity(done_j, done_t, st_j, st_t)
    assert st_t["scenecache"] == st_j["scenecache"]


def test_engine_same_round_duplicate_blocks_dedup():
    """Identical requests admitted in the same round: in-batch dedup and
    the pool sweep march each distinct block once, the frames match, and
    the store's first-touch counters equal the reference's."""
    from test_torch_render_serve import assert_parity, run_both
    spec = [(i, "mic", 0.7, 0.5) for i in range(3)]
    done_j, done_t, st_j, st_t = run_both(
        spec, slots=4, blocks_per_batch=4, reuse=None,
        scenecache=dict(byte_budget=8 << 20))
    assert_parity(done_j, done_t, st_j, st_t)
    assert st_t["blocks_marched"] == 9
    assert st_t["scene_block_hits"] == 18
    by = {r.rid: r for r in done_t}
    for rid in (1, 2):
        np.testing.assert_array_equal(by[0].image, by[rid].image)
    assert st_t["scenecache"] == st_j["scenecache"]
    assert st_t["scenecache"]["misses"] == 27
