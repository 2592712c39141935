"""Port parity: the render serving engine (serve/) against the JAX
reference's, on the analytic mic and hotdog scenes and a small NGP whose
weights are carried across from JAX.

The same requests go through both engines: images within rtol 1e-4 /
atol 1e-5; each request's flags, rays marched, samples processed and
reused, probe samples and block hits exact; the finish order, the
``DETERMINISTIC_COUNTERS`` and the ``engine_stats()`` keys equal.  Also
the port's own properties: identity with ``render_asdr_image``, the
streaming dispatch, the round ledger, the weight-pack LRU, the per-ray
exit price, density refresh, seeded probes and the launcher.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro import framecache as jfc
from repro import scenecache as jsc_
from repro.core import fields as jfields
from repro.core import pipeline as jpl
from repro.core import scene as jsc
from repro.core.model import NGPConfig as JNGPConfig, init_ngp
from repro.core.model import field_fns as j_field_fns
from repro.serve import render_engine as jre
from repro.serve import stats as jstats
from repro_torch import framecache as tfc
from repro_torch import params as tparams
from repro_torch import scenecache as tsc_
from repro_torch.core import fields as tfields
from repro_torch.core import model as tmodel
from repro_torch.core import pipeline as tpl
from repro_torch.core import scene as tsc
from repro_torch.kernels import ops as tops
from repro_torch.launch import render_serve as t_launch
from repro_torch.serve import pool as tpool
from repro_torch.serve import render_engine as tre
from repro_torch.serve import stats as tstats

ACFG = dict(ns_full=48, probe_stride=4, candidates=(8, 16, 32), block_size=64,
            chunk=16)
SIZE = 24
RTOL, ATOL = 1e-4, 1e-5
TABLE_GAIN = 300.0
STAT_KEYS = ("probe_reused", "probe_skipped", "radiance_reused",
             "rays_marched", "rays_total", "samples_processed",
             "samples_reused", "probe_samples", "scene_block_hits",
             "density_rays", "tier", "degrades")
# per-config sub-configs, built in each package from the same kwargs
SUBCONFIGS = {"reuse": "ProbeReuseConfig", "radiance": "RadianceReuseConfig"}

_FIELDS = {}


def field_pairs():
    """{scene: (JAX FieldFns, port FieldFns)}: analytic mic and hotdog and
    a small NGP (the reference's init, tables scaled so the probe spans
    the ladder) carried across with ``params.from_jax_params``."""
    if not _FIELDS:
        cfg = JNGPConfig.small()
        params = dict(init_ngp(jax.random.PRNGKey(3), cfg))
        params["grid"] = params["grid"] * TABLE_GAIN
        field = tparams.from_jax_params(jax.tree.map(np.asarray, params),
                                        cfg, device="cpu")
        for s in ("mic", "hotdog"):
            _FIELDS[s] = (jfields.analytic_field_fns(jsc.make_scene(s)),
                          tfields.analytic_field_fns(tsc.make_scene(s)))
        _FIELDS["ngp"] = (j_field_fns(params, cfg), tmodel.field_fns(field))
        _FIELDS["ngp_field"] = field
    return _FIELDS


def acfgs(**kw):
    return jpl.ASDRConfig(**ACFG, **kw), tpl.ASDRConfig(**ACFG, **kw)


def serve_cfgs(**kw):
    """(JAX, port) RenderServeConfig from one set of kwargs: ``reuse`` /
    ``radiance`` / ``scenecache`` given as dicts of their config's fields
    (None = off; ``reuse`` defaults to ProbeReuseConfig())."""
    out = []
    for fc, sc, re_ in ((jfc, jsc_, jre), (tfc, tsc_, tre)):
        k = dict(kw)
        for name, cls in SUBCONFIGS.items():
            if isinstance(k.get(name), dict):
                k[name] = getattr(fc, cls)(**k[name])
        if isinstance(k.get("scenecache"), dict):
            k["scenecache"] = sc.SceneCacheConfig(**k["scenecache"])
        if "policy" in k and not isinstance(k["policy"], (str, type(None))):
            k["policy"] = getattr(re_, type(k["policy"]).__name__)(
                **dataclasses.asdict(k["policy"]))
        out.append(re_.RenderServeConfig(**k))
    return out


def requests(spec, classes=None, size=SIZE):
    """(JAX, port) request lists from [(rid, scene, theta, phi), ...] at
    ``size`` x ``size``; ``classes`` {rid: RequestClass kwargs}."""
    classes = classes or {}
    out = []
    for sc, re_ in ((jsc, jre), (tsc, tre)):
        out.append([re_.RenderRequest(
            rid=rid, scene=scene, cam=sc.look_at_camera(size, size, theta=th,
                                                        phi=ph),
            **({"cls": re_.RequestClass(**classes[rid])}
               if rid in classes else {}))
            for rid, scene, th, ph in spec])
    return out


def traj(n=8, scenes=("mic", "hotdog"), step=0.02, phi=0.5):
    """k-major over scenes, as the launcher interleaves them."""
    return [(i, scenes[i % len(scenes)], 0.7 + step * (i // len(scenes)),
             phi) for i in range(n)]


def run_port(spec, acfg_kw=None, scenes=None, classes=None, size=SIZE,
             **rcfg_kw):
    """Render ``spec`` through the port's engine alone.  Returns (done,
    engine_stats)."""
    flds = field_pairs()
    names = scenes or sorted({s for _, s, _, _ in spec})
    eng = tre.RenderServingEngine({n: flds[n][1] for n in names},
                                  acfgs(**(acfg_kw or {}))[1],
                                  serve_cfgs(**rcfg_kw)[1], device="cpu")
    try:
        return eng.render(requests(spec, classes, size)[1]), eng.engine_stats()
    finally:
        eng.close()


def run_both(spec, acfg_kw=None, scenes=None, classes=None, stores=None,
             size=SIZE, **rcfg_kw):
    """Render ``spec`` through both engines.  Returns (JAX done, port done,
    JAX stats, port stats)."""
    flds = field_pairs()
    names = scenes or sorted({s for _, s, _, _ in spec})
    acfg_j, acfg_t = acfgs(**(acfg_kw or {}))
    rc_j, rc_t = serve_cfgs(**rcfg_kw)
    eng_j = jre.RenderServingEngine({n: flds[n][0] for n in names}, acfg_j,
                                    rc_j, **({"scenecache": stores[0]}
                                             if stores else {}))
    eng_t = tre.RenderServingEngine({n: flds[n][1] for n in names}, acfg_t,
                                    rc_t, device="cpu",
                                    **({"scenecache": stores[1]}
                                       if stores else {}))
    req_j, req_t = requests(spec, classes, size)
    try:
        done_j, done_t = eng_j.render(req_j), eng_t.render(req_t)
        return done_j, done_t, eng_j.engine_stats(), eng_t.engine_stats()
    finally:
        eng_j.close()
        eng_t.close()


def assert_parity(done_j, done_t, st_j, st_t, order=True):
    if order:
        assert [r.rid for r in done_t] == [r.rid for r in done_j]
    by_rid = {r.rid: r for r in done_j}
    assert sorted(by_rid) == sorted(r.rid for r in done_t)
    for r in done_t:
        ref = by_rid[r.rid]
        assert isinstance(r.image, np.ndarray)
        np.testing.assert_allclose(r.image, np.asarray(ref.image), rtol=RTOL,
                                   atol=ATOL, err_msg=f"request {r.rid}")
        for k in STAT_KEYS:
            assert r.stats[k] == ref.stats[k], (r.rid, k, r.stats[k],
                                                ref.stats[k])
    assert tstats.DETERMINISTIC_COUNTERS == jstats.DETERMINISTIC_COUNTERS
    for c in tstats.DETERMINISTIC_COUNTERS:
        assert st_t[c] == st_j[c], (c, st_t[c], st_j[c])
    assert st_t.keys() == st_j.keys()
    for k in ("batches", "pad_block_fraction", "scene_block_hits",
              "full_radiance_hits", "requests_shed", "requests_full"):
        assert st_t[k] == st_j[k], (k, st_t[k], st_j[k])


REUSE = dict(reuse=dict(refresh_every=0), radiance=dict(refresh_every=0))


@pytest.mark.parametrize("name,kw", [
    ("fresh", dict(reuse=None)),
    ("probe-reuse", dict()),
    ("all-tiers", dict(REUSE, scenecache=dict(byte_budget=8 << 20))),
    ("prefetch0", dict(REUSE, prefetch=0)),
    ("workers2", dict(REUSE, workers=2)),
    ("inflight2", dict(REUSE, inflight_batches=2)),
    ("edf", dict(REUSE, policy="edf")),
    ("density-refresh", dict(REUSE, density_refresh=True, slots=1)),
])
def test_engine_matches_reference(name, kw):
    """Two scenes, 8 requests k-major (four poses each, 1.1 degrees
    apart), in every engine variant: the port's engine against the JAX
    engine on the same requests."""
    kw = dict(kw)
    assert_parity(*run_both(traj(), blocks_per_batch=4,
                            slots=kw.pop("slots", 2), **kw))


@pytest.mark.parametrize("radiance", [False, True])
def test_ngp_engine_matches_reference(radiance):
    """The small NGP through both engines, two viewers of the same poses:
    with the block store alone the second's blocks come from the store;
    with radiance reuse on its frames are warps of the first's."""
    spec = [(i, "ngp", 0.7 + 0.02 * (i % 4), 0.5) for i in range(8)]
    done_j, done_t, st_j, st_t = run_both(
        spec, blocks_per_batch=4, slots=2, reuse=dict(refresh_every=0),
        radiance=dict(refresh_every=0) if radiance else None,
        scenecache=dict(byte_budget=8 << 20))
    assert_parity(done_j, done_t, st_j, st_t)
    assert st_t["radiance_hits" if radiance else "scene_block_hits"] > 0


def test_engine_matches_single_image_pipeline():
    """Pooled serving is bit-identical to rendering each view alone through
    render_asdr_image (fresh probes, stable sort), for both scenes."""
    flds = field_pairs()
    _, acfg = acfgs()
    cam = tsc.look_at_camera(SIZE, SIZE, theta=0.7, phi=0.5)
    eng = tre.RenderServingEngine({s: flds[s][1] for s in ("mic", "hotdog")},
                                  acfg, tre.RenderServeConfig(
                                      slots=2, blocks_per_batch=4,
                                      reuse=None), device="cpu")
    done = {r.rid: r for r in eng.render([
        tre.RenderRequest(rid=0, scene="mic", cam=cam),
        tre.RenderRequest(rid=1, scene="hotdog", cam=cam)])}
    for rid, sc in ((0, "mic"), (1, "hotdog")):
        ref, st = tpl.render_asdr_image(flds[sc][1], acfg, cam, device="cpu")
        np.testing.assert_array_equal(done[rid].image, ref.numpy())
        assert done[rid].stats["samples_processed"] == st["samples_processed"]
        assert done[rid].stats["probe_samples"] == st["probe_samples"]


def test_streaming_dispatch_bit_identical():
    """inflight_batches > 1 changes only WHEN batches launch: frames and
    deterministic counters equal the one-batch-per-round engine's, while
    the streaming engine's rounds carry several batches."""
    spec = [(i, s, 0.7, 0.5) for i, s in enumerate(["mic", "hotdog"] * 2)]
    one = run_both(spec, reuse=None, slots=4, blocks_per_batch=2,
                   inflight_batches=1)
    many = run_both(spec, reuse=None, slots=4, blocks_per_batch=2,
                    inflight_batches=3)
    assert_parity(*many)
    d1, dn = {r.rid: r for r in one[1]}, {r.rid: r for r in many[1]}
    for rid in d1:
        np.testing.assert_array_equal(d1[rid].image, dn[rid].image)
    for k in tstats.DETERMINISTIC_COUNTERS:
        assert one[3][k] == many[3][k], k
    assert max(many[3]["batches_per_round"]) > 1
    assert max(one[3]["batches_per_round"]) == 1


def test_march_round_observability():
    """engine_stats() exposes the round ledger: wall-time percentiles and a
    batches-per-round histogram whose mass equals the batch count."""
    _, _, _, st = run_both([(0, "mic", 0.7, 0.5), (1, "hotdog", 0.7, 0.5)],
                           reuse=None, slots=2, blocks_per_batch=4,
                           inflight_batches=2)
    assert st["march_rounds"] > 0
    assert st["march_ms_p50"] > 0.0 and st["march_ms_p99"] > 0.0
    hist = st["batches_per_round"]
    assert hist and sum(k * v for k, v in hist.items()) == st["batches"]
    assert sum(hist.values()) == st["march_rounds"]


def test_engine_stats_expose_pack_cache():
    """engine_stats() surfaces the weight-pack LRU's ledger: a field whose
    weights were never packed is a miss, packing them again is a hit."""
    flds = field_pairs()
    _, acfg = acfgs()
    eng = tre.RenderServingEngine({"mic": flds["mic"][1]}, acfg,
                                  tre.RenderServeConfig(slots=1,
                                                        blocks_per_batch=2,
                                                        reuse=None),
                                  device="cpu")
    st0 = eng.engine_stats()
    for k in ("pack_cache_hits", "pack_cache_misses", "pack_cache_size"):
        assert k in st0, k
    direct = tops.pack_cache_stats()
    assert st0["pack_cache_hits"] == direct["hits"]
    assert st0["pack_cache_misses"] == direct["misses"]
    field = tparams.from_jax_params(
        jax.tree.map(np.asarray, init_ngp(jax.random.PRNGKey(42),
                                          JNGPConfig.small())),
        JNGPConfig.small(), device="cpu")
    d1, c1 = tops.packed_weights(field)
    res = tops.FusedMarchResources(field)         # the kernel field's path
    st1 = eng.engine_stats()
    eng.close()
    assert st1["pack_cache_misses"] == st0["pack_cache_misses"] + 1
    assert st1["pack_cache_hits"] == st0["pack_cache_hits"] + 1
    assert st1["pack_cache_size"] >= 1
    assert res.density[0] is d1[0] and res.color[0] is c1[0]
    for (flat, dims), ws in ((d1, field.density_weights),
                             (c1, field.color_weights)):
        assert dims == (ws[0].shape[0],) + tuple(w.shape[1] for w in ws)
        torch.testing.assert_close(
            flat, torch.cat([w.reshape(-1) for w in ws]), rtol=0, atol=0)


def test_pack_cache_is_bounded_and_keyed_on_the_tensors():
    """The LRU holds at most its bound, and a field over new tensors (a
    retrained scene) is a miss even where an old entry's weights were
    equal."""
    cfg = JNGPConfig.small()
    host = jax.tree.map(np.asarray, init_ngp(jax.random.PRNGKey(7), cfg))
    fields = [tparams.from_jax_params(host, cfg, device="cpu")
              for _ in range(tops._PACK_MAX + 2)]
    before = tops.pack_cache_stats()
    for f in fields:
        tops.packed_weights(f)
    after = tops.pack_cache_stats()
    assert after["misses"] - before["misses"] == len(fields)
    assert after["size"] == tops._PACK_MAX


def test_ray_exit_skip_counter():
    """pool.collect prices per-ray early exit: with the flag on, the gap
    between each block's chunk count and its rays' live-chunk counts
    lands in ``ray_exit_samples_skipped`` (real blocks only); with the
    flag off the counter stays zero."""
    class _FakeReq:
        rid, scene = 0, "mic"

    class _FakeSlot:
        req = _FakeReq()

        def deliver(self, bi, rgb, acc, depth, chunks, cached=False):
            pass

    B = 4
    _, acfg = acfgs()
    acfg = dataclasses.replace(acfg, block_size=B, per_ray_early_exit=True)
    counters = tstats.EngineCounters()
    batch = [(_FakeSlot(), 0, None, None, 64, None, None, False)]
    out = (torch.zeros((2, B, 3)), torch.zeros((2, B)), torch.zeros((2, B)),
           torch.tensor([4, 1]), torch.tensor([[4, 2, 1, 4], [1, 1, 1, 1]]))
    tpool.BlockPool(acfg, 2, None, counters).collect(
        (batch, [], 1, out, 1, None, time.perf_counter()))
    assert counters.ray_exit_samples_skipped == 5 * acfg.chunk
    counters2 = tstats.EngineCounters()
    tpool.BlockPool(acfgs()[1], 2, None, counters2).collect(
        (batch, [], 1, out, 2, None, time.perf_counter()))
    assert counters2.ray_exit_samples_skipped == 0
    assert "ray_exit_samples_skipped" in tstats.engine_stats(counters, {},
                                                             {}, None)


def test_per_ray_exit_engine_matches_reference():
    """With per-ray early exit on, the engine's frames, counters and the
    skipped-samples price match the reference's."""
    done_j, done_t, st_j, st_t = run_both(
        traj(4), acfg_kw=dict(per_ray_early_exit=True), reuse=None, slots=2,
        blocks_per_batch=4)
    assert_parity(done_j, done_t, st_j, st_t)
    assert st_t["ray_exit_samples_skipped"] == st_j["ray_exit_samples_skipped"]


def test_density_refresh_enables_radiance_chaining():
    """Opt-in density refresh: partially-warped frames re-march their
    warp-valid rays color-free, so they enter the radiance cache and later
    frames warp FROM them: more radiance hits than without, and every frame
    close to the never-reuse render."""
    spec = [(i, "mic", 0.7 + 0.025 * i, 0.5) for i in range(4)]
    kw = dict(slots=1, blocks_per_batch=4, size=32)
    base = run_port(spec, prefetch=0, radiance={}, **kw)
    refr = run_port(spec, prefetch=0, radiance={}, density_refresh=True,
                    **kw)
    full = run_port(spec, reuse=None, **kw)
    assert refr[1]["radiance_hits"] > base[1]["radiance_hits"]
    assert any(r.stats["density_rays"] > 0 for r in refr[0])
    ref = {r.rid: r.image for r in full[0]}
    for r in refr[0]:
        mse = float(np.mean((r.image - ref[r.rid]) ** 2))
        assert -10 * np.log10(mse + 1e-20) > 30.0, r.rid


def test_seeded_probe_matches_reference_with_its_draws(monkeypatch):
    """A seeded request's probe draws are the port's own generator's; given
    JAX's own draws (``uniform(PRNGKey(probe_seed + rid))``) the rest of
    the seeded request matches the reference."""
    from repro_torch.serve import admission as tadm
    _, acfg = acfgs()

    def jax_draws(rcfg, req, acfg_, device):
        st = acfg_.probe_stride
        n = (-(-req.cam.height // st)) * (-(-req.cam.width // st))
        key = jax.random.PRNGKey(rcfg.probe_seed + req.rid)
        return torch.from_numpy(np.array(
            jax.random.uniform(key, (n, acfg_.ns_full)))).to(device)

    own = tadm.probe_jitter_for(tre.RenderServeConfig(probe_seed=5),
                                requests([(1, "mic", 0.7, 0.5)])[1][0],
                                acfg, "cpu")
    assert own.shape == ((SIZE // 4) ** 2, acfg.ns_full)
    assert float(own.min()) >= 0.0 and float(own.max()) < 1.0
    assert tadm.probe_jitter_for(tre.RenderServeConfig(), None, acfg,
                                 "cpu") is None
    monkeypatch.setattr(tadm, "probe_jitter_for", jax_draws)
    assert_parity(*run_both(traj(4), reuse=None, slots=2, blocks_per_batch=4,
                            probe_seed=5))


def test_launcher_scenecache_smoke():
    """The launcher's scene-block smoke: two clients replay the same poses
    through the shared store, so the second client's blocks are all hits
    and the store holds the first's, none evicted."""
    out = t_launch.scenecache_smoke(device="cpu")
    assert out["clients"] == 2 and out["poses"] == 3
    assert out["scene_block_hits"] == out["blocks_marched"] == 12
    assert out["scene_block_hit_rate"] == 0.5
    assert out["entries"] == 12 and out["evictions"] == 0
    assert 0 < out["resident_bytes"] <= out["byte_budget"]


def test_launcher_concrete_runs_on_cpu(capsys):
    """``python -m repro_torch.launch.render_serve --device cpu`` end to
    end: two interleaved analytic scenes, all tiers."""
    import sys
    argv = sys.argv
    sys.argv = ["render_serve", "--device", "cpu", "--poses", "4", "--size",
                "16", "--block", "64", "--scenecache-mb", "4", "--stats"]
    try:
        t_launch.main()
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert "[render_serve] 4 frames 16x16" in out
    assert "scene-block reuse" in out and '"frames": 4' in out
