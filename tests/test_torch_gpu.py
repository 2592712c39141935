"""The rebuilt kernels on the card: the hash encode, density, march and
volume-render kernels held to their plain versions bit for bit on small
inputs (the hash encode at ragged point counts, feature widths and level
counts, rows that are no power of two, a table off 8-B alignment), flash
attention within its tolerances (fp32 and bf16, window, softcap, GQA
ratios 1, 2 and 8, lengths off the tile grid), and the launchers asking
for the shared memory (and, for flash attention, the tiles and grid) the
wrappers reckon.  Training steps on the card against the same steps on
the CPU, and the kernel field of a trained field against its plain
field.  The fused march over a subset of a frame's blocks, in any order,
against those blocks' rows of the full launch, and a short reuse
trajectory on the kernel and plain fields.  Marked ``gpu``: they skip
without a CUDA device and run
on a machine with an H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import framecache, optim, params, scenecache
from repro_torch.configs import ingp_asdr
from repro_torch.core import model, pipeline, rendering, scene, train
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import hash_encode as HE
from repro_torch.kernels import fused_march as FMA
from repro_torch.kernels import fused_mlp as FM
from repro_torch.kernels import ops
from repro_torch.kernels import volume_render as VR
from test_torch_march_tiles import (CASES, PAPER_COLOR, PAPER_DENSITY,
                                    _march_inputs)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build and run only "
                    "there)")
    return torch.device("cuda")


def test_launchers_ask_for_the_reckoned_shared_memory(cuda):
    assert FM.density_launch_smem(PAPER_DENSITY) == FM.density_smem_bytes(
        PAPER_DENSITY)
    for S, chunk, L in ((16, 32, 16), (0, 32, 16), (16, 64, 5), (9, 7, 8)):
        assert FMA.launch_smem(PAPER_DENSITY, PAPER_COLOR, S, chunk, L) == \
            FMA.smem_bytes(PAPER_DENSITY, PAPER_COLOR, S, chunk, L)


def test_density_mlp_matches_plain(cuda):
    rng = np.random.default_rng(3)
    dims = PAPER_DENSITY
    enc = rng.normal(0, 2, (1000, dims[0])).astype(np.float32)
    w = rng.normal(0, 0.3, FM.chain_size(dims)).astype(np.float32)
    enc, w = torch.from_numpy(enc).to(cuda), torch.from_numpy(w).to(cuda)
    got = FM.density_mlp(enc, w, dims)
    assert torch.equal(got, FM.density_mlp_plain(enc, w, dims))


@pytest.mark.parametrize("name", list(CASES))
def test_fused_march_matches_plain(name, cuda):
    args, kw = _march_inputs(name, table_scale=30.0)
    args = tuple(a.to(cuda) if torch.is_tensor(a) else a for a in args)
    got = FMA.fused_march(*args, **kw)
    assert torch.equal(got, FMA.fused_march_plain(*args, **kw))


# rtol, atol, and a limit on ||got - want|| / ||want|| (bf16: 2-3x the
# error measured on the card: max 3.9e-3, one bf16 step of the output;
# norm 0.8-1.0e-3).
ATTN_TOL = {torch.float32: (2e-4, 2e-5, None),
            torch.bfloat16: (1e-2, 8e-3, 3e-3)}


def assert_attention_close(got, want, dtype):
    rtol, atol, rel = ATTN_TOL[dtype]
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    if rel is not None:
        assert torch.linalg.norm(got - want) <= rel * torch.linalg.norm(want)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (40, 0.0), (0, 50.0),
                                            (100, 30.0)])
@pytest.mark.parametrize("ratio", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(dtype, ratio, window, softcap, cuda):
    rng = np.random.default_rng(ratio + window)
    B, S, KV, Dh = 2, 333, 2, 64
    H = KV * ratio
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
               .to(cuda).to(dtype)
               for sh in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh)))
    got = FA.flash_attention(q, k, v, window, softcap)
    want = FA.flash_attention_plain(q, k, v, window, softcap)
    assert got.dtype == dtype
    assert_attention_close(got, want, dtype)


@pytest.mark.parametrize("Dh", [16, 48, 80, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_widths(dtype, Dh, cuda):
    rng = np.random.default_rng(Dh)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
               .to(cuda).to(dtype)
               for sh in ((1, 200, 4, Dh), (1, 200, 2, Dh), (1, 200, 2, Dh)))
    assert_attention_close(FA.flash_attention(q, k, v, 48, 0.0),
                           FA.flash_attention_plain(q, k, v, 48), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_launcher_uses_the_reckoned_tiles(dtype, cuda):
    for Dh, S in ((128, 8192), (64, 333), (16, 1)):
        assert FA.launch_config(Dh, 2, S, 8, dtype) == (
            FA.QUERY_TILE[dtype], FA.KEY_TILE[dtype], FA.smem_bytes(Dh, dtype),
            *FA.grid(2, S, 8, dtype))


DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
KEY_TILE_CASES = [(dtype, S, window) for dtype in DTYPES
                  for S in (200, 333, 512) for window in (0, 1, 48, 100, 130)]


def direct_key_tiles(S, window, dt):
    """{first row of each query tile: first keys of the key tiles holding an
    unmasked (query, key) pair of its rows}, counted pair by pair."""
    qb, kb = FA.QUERY_TILE[dt], FA.KEY_TILE[dt]
    qi = np.arange(S)[:, None]
    kj = np.arange(S)[None, :]
    keep = kj <= qi
    if window:
        keep &= qi - kj < window
    return {q0: sorted({k // kb * kb
                        for k in np.nonzero(keep[q0:q0 + qb].any(axis=0))[0]})
            for q0 in range(0, S, qb)}


@pytest.mark.parametrize("dtype,S,window", KEY_TILE_CASES)
def test_flash_kernel_key_tiles_match_a_direct_count(dtype, S, window, cuda):
    """The key tiles the compiled kernels load for each query tile are those
    holding an unmasked pair, as the CPU test holds the wrapper's
    reckoning."""
    dt = DTYPES[dtype]
    for q0, tiles in direct_key_tiles(S, window, dt).items():
        assert list(FA.launched_key_tiles(q0, S, window, dt)) == tiles, q0


@pytest.mark.parametrize("R,S,A,group", [(1005, 50, 1, 3), (1005, 50, 17, 3),
                                         (77, 192, 96, 2), (33, 7, 3, 3),
                                         (64, 64, 64, 1)])
def test_volume_render_matches_plain(R, S, A, group, cuda):
    rng = np.random.default_rng(R + S)
    sig = torch.from_numpy(rng.uniform(0, 8, (R, S)).astype(np.float32))
    dl = torch.from_numpy(rng.uniform(0, 0.05, (R, S)).astype(np.float32))
    anch = torch.from_numpy(rng.uniform(size=(R, A, 3)).astype(np.float32))
    sig, dl, anch = sig.to(cuda), dl.to(cuda), anch.to(cuda)
    want = VR.volume_render_plain(sig, dl, anch, group)
    assert torch.equal(VR.volume_render(sig, dl, anch, group), want)
    # one float off 16-B alignment: the kernel's 4-B copies
    flat = torch.zeros(anch.numel() + 1, device=cuda)
    flat[1:] = anch.reshape(-1)
    assert torch.equal(VR.volume_render(sig, dl, flat[1:].view(R, A, 3),
                                        group), want)


def test_volume_render_launcher_asks_for_the_reckoned_shared_memory(cuda):
    for S, A, group in ((192, 96, 2), (50, 1, 3), (64, 64, 1), (7, 3, 3),
                        (1000, 10, 100)):
        assert VR.volume_render_launch_smem(S, A, group) == \
            VR.volume_render_smem_bytes(S, A, group)


def _encode_inputs(n, F, L, rows, seed):
    """Points in [-0.25, 1.25]^3 (some outside the cube) and (L, rows, F)
    tables; levels at resolutions 4 .. 300, dense where (res+1)^3 fits."""
    rng = np.random.default_rng(seed)
    res = np.unique(np.geomspace(4, 300, L).astype(int))
    res = np.concatenate([res, 300 + np.arange(L - len(res))])
    meta = [[int(r), int((r + 1) ** 3 <= rows), rows] for r in res]
    pts = rng.uniform(-0.25, 1.25, (n, 3)).astype(np.float32)
    tables = rng.uniform(-3, 3, (L, rows, F)).astype(np.float32)
    return (torch.from_numpy(pts), torch.tensor(meta, dtype=torch.int32),
            torch.from_numpy(tables))


@pytest.mark.parametrize("L", [5, 16])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 31, 33, 1000])
def test_hash_encode_matches_plain(n, F, L, cuda):
    """Point counts off the warp, every group width (F = 1: 8 levels a
    group, so L = 5 is one ragged group; F = 2: 4; F = 4: 2; F = 8: 1)."""
    pts, meta, tables = (t.to(cuda) for t in
                         _encode_inputs(n, F, L, 1 << 12, n + F + L))
    got = HE.hash_encode(pts, meta, tables)
    assert torch.equal(got, HE.hash_encode_plain(pts, meta, tables))


@pytest.mark.parametrize("F", [1, 2, 3, 6])
def test_hash_encode_rows_not_a_power_of_two(F, cuda):
    """Hashed rows taken mod 3,001 (not masked), F = 3 and 6 store
    scalars, L = 7 leaves a ragged last group."""
    pts, meta, tables = (t.to(cuda) for t in
                         _encode_inputs(777, F, 7, 3001, F))
    assert not all(meta[:, 1].tolist())
    got = HE.hash_encode(pts, meta, tables)
    assert torch.equal(got, HE.hash_encode_plain(pts, meta, tables))


def test_hash_encode_table_off_8_byte_alignment(cuda):
    """F = 2 tables 4 B past an 8-B boundary take the scalar loads."""
    pts, meta, tables = (t.to(cuda) for t in
                         _encode_inputs(1000, 2, 16, 1 << 12, 5))
    flat = torch.zeros(tables.numel() + 1, device=cuda)
    flat[1:] = tables.reshape(-1)
    shifted = flat[1:].view(tables.shape)
    assert shifted.data_ptr() % 8 == 4
    want = HE.hash_encode_plain(pts, meta, tables)
    assert torch.equal(HE.hash_encode(pts, meta, shifted), want)


# The paper's MLP widths (the tile kernels' shapes) over a small grid.
TRAIN_MODEL = model.NGPConfig.make(log2_table_size=14, max_resolution=256,
                                   paper_mlp=True)
TRAIN_CFG = train.NGPTrainConfig(steps=3, batch_rays=256, n_samples=32,
                                 n_views=2, view_hw=(24, 24), log_every=1)


def test_training_steps_match_the_cpu(cuda):
    """Three steps on the card and on the CPU from the same params, batch
    indices and jitter, held as the CPU parity test holds them against
    the reference: the first step's grads within 1e-4 of each leaf's
    largest |g|, losses at rtol 1e-4, and at least 99.9 % of each leaf
    within atol 1e-6 + rtol 1e-4, every entry within 3 lr (Adam moves an
    entry whose gradient is within rounding of 0 by about lr either way;
    the gather's backward sums in another order on the card)."""
    cpu = torch.device("cpu")
    params = model.init_ngp(TRAIN_MODEL, torch.Generator().manual_seed(0),
                            device=cpu)
    rays = train._make_view_rays(TRAIN_CFG, scene.make_scene("lego"), cpu)
    rng = np.random.default_rng(0)
    batches = [(torch.from_numpy(rng.integers(0, rays[0].shape[0], 256)),
                torch.from_numpy(rng.uniform(size=(256, 32)).astype(np.float32)))
               for _ in range(TRAIN_CFG.steps)]
    opt = optim.AdamWConfig(lr=TRAIN_CFG.lr, b2=0.99, eps=1e-15)
    sched = optim.cosine_schedule(TRAIN_CFG.lr, TRAIN_CFG.steps)
    step = train.make_train_step(TRAIN_CFG, TRAIN_MODEL, opt)
    out = []
    for dev in (cpu, cuda):
        p = optim.tree_map(lambda t: t.to(dev), params)
        o, d, ref = (r.to(dev) for r in rays)
        idx, jit = (t.to(dev) for t in batches[0])
        _, grads = train.loss_and_grads(p, TRAIN_MODEL, o[idx], d[idx],
                                        ref[idx], jit, TRAIN_CFG.n_samples)
        state, losses = optim.adamw_init(p, opt), []
        for i, (idx, jit) in enumerate(batches):
            idx, jit = idx.to(dev), jit.to(dev)
            p, state, loss = step(p, state, o[idx], d[idx], ref[idx], jit,
                                  sched(i))
            losses.append(float(loss))
        out.append((optim.tree_leaves(grads), losses, optim.tree_leaves(p)))
    (g_c, l_c, p_c), (g_g, l_g, p_g) = out
    for got, want in zip(g_g, g_c):
        assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max()
    np.testing.assert_allclose(l_g, l_c, rtol=1e-4)
    for got, want in zip(p_g, p_c):
        err = (got.cpu() - want).abs()
        assert float((err <= 1e-6 + 1e-4 * want.abs()).float().mean()) >= 0.999
        assert float(err.max()) <= 3 * TRAIN_CFG.lr


def test_kernel_field_of_a_trained_field_matches_plain(cuda):
    """``ops.field_fns`` packs a field's MLP weights by copy when it is
    built (its tables by reference), so a kernel field is built from the
    trained ``NGPField``: it then agrees with the plain field on the
    trained weights (rtol 1e-4 / atol 1e-5), where one built from the
    initial weights does not."""
    field, _, _, hist = train.train_ngp(
        dataclasses.replace(TRAIN_CFG, steps=20), TRAIN_MODEL, device=cuda,
        verbose=False)
    assert hist[-1][1] < hist[0][1]
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(-0.1, 1.1, (5000, 3)).astype(
        np.float32)).to(cuda)
    dirs = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(5000, 3)).astype(np.float32)).to(cuda), dim=-1)
    plain = model.field_fns(field)
    sig_p, geo_p = plain.density(pts)
    rgb_p = plain.color(geo_p, dirs)
    kern = ops.field_fns(field)
    sig_k, geo_k = kern.density(pts)
    torch.testing.assert_close(sig_k, sig_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(geo_k, geo_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(kern.color(geo_p, dirs), rgb_p, rtol=1e-4,
                               atol=1e-5)
    init = model.init_ngp(TRAIN_MODEL, torch.Generator(cuda).manual_seed(
        TRAIN_CFG.seed), device=cuda)
    stale = ops.field_fns(model.NGPField.from_params(TRAIN_MODEL, init))
    assert not torch.allclose(stale.color(geo_p, dirs), rgb_p, rtol=1e-4,
                              atol=1e-5)


@pytest.fixture(scope="module")
def paper_field():
    """The paper-config NGP with random weights on the card (tables
    uniform(-30, 30), as the smoke's: a count map over several rungs and
    blocks that exit early), and the 800x800 view's blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build and run only "
                    "there)")
    cuda = torch.device("cuda")
    bundle = ingp_asdr.CONFIG
    field = params.from_jax_params(params.random_params(bundle.model, 8, 30.0),
                                   bundle.model, device=cuda)
    return field, bundle


@pytest.mark.parametrize("density_only", [False, True])
@pytest.mark.parametrize("per_ray", [False, True])
def test_fused_march_block_subsets_match_the_full_launch(paper_field,
                                                         density_only,
                                                         per_ray):
    """What scenecache/render.py relies on: the fused march gives a block
    the same rows, to the bit, whatever other blocks share its launch, and
    in whatever order they come."""
    field, bundle = paper_field
    acfg = dataclasses.replace(bundle.asdr, march_backend="fused",
                               per_ray_early_exit=per_ray)
    fns = ops.field_fns(field)
    cam = scene.look_at_camera(*bundle.image_hw, theta=0.9, phi=0.55)
    o, d = scene.camera_rays(cam)
    counts, _ = pipeline.probe_phase(fns, acfg, cam)
    o, d, counts, _, _ = pipeline.pad_rays_to_blocks(acfg, o, d, counts)
    order, budgets = pipeline.block_sort(acfg, counts)
    B = acfg.block_size
    o_s, d_s = o[order].reshape(-1, B, 3), d[order].reshape(-1, B, 3)
    nb = budgets.shape[0]
    full = ops.fused_march_blocks(fns.fused, acfg, o_s, d_s, budgets,
                                  density_only)
    assert len(set(budgets.tolist())) >= 2
    for sub in (list(range(0, nb, 3)), list(range(nb - 1, -1, -2)), [nb - 1],
                [5, 0, 77, 76, 140]):
        at = torch.tensor(sub, device=o.device)
        part = ops.fused_march_blocks(fns.fused, acfg, o_s[at], d_s[at],
                                      budgets[at], density_only)
        for got, want in zip(part, full):
            assert torch.equal(got, want[at])


def test_reuse_trajectory_kernel_matches_plain(paper_field):
    """Five 800x800 poses, 0.57 degrees a step, through every reuse tier
    on the kernel field (fused march) and on the plain field: equal reuse
    flags, rays marched and count maps within 0.1 %, PSNRs against the
    kernel field's fixed-192 render of each pose within 0.1 dB; frame 0
    equals render_asdr_image bit for bit."""
    field, bundle = paper_field
    acfg = dataclasses.replace(bundle.asdr, march_backend="fused")
    H, W = bundle.image_hw
    cams = [scene.look_at_camera(H, W, theta=0.9 + 0.01 * k, phi=0.55)
            for k in range(5)]
    fns_k, fns_p = ops.field_fns(field), model.field_fns(field)
    runs = []
    for fns in (fns_k, fns_p):
        fc = framecache.make_frame_cache(
            scene_cache=scenecache.SceneBlockCache(), scene_id="random")
        runs.append([framecache.render_asdr_image_cached(fns, acfg, cam, fc)
                     for cam in cams])
    ref0, st0 = pipeline.render_asdr_image(fns_k, acfg, cams[0])
    assert torch.equal(runs[0][0][0], ref0)
    assert torch.equal(runs[0][0][1]["counts"], st0["counts"])
    assert [s["radiance_reused"] for _, s in runs[0]] == [
        False, True, True, True, False]
    for cam, (img_k, st_k), (img_p, st_p) in zip(cams, *runs):
        for f in ("probe_reused", "probe_skipped", "radiance_reused"):
            assert st_k[f] == st_p[f], f
        assert abs(st_k["rays_marched"] - st_p["rays_marched"]) <= \
            1e-3 * H * W
        if st_k["counts"] is not None:
            assert float((st_k["counts"] != st_p["counts"]).float().mean()) \
                <= 1e-3
        o, d = scene.camera_rays(cam)
        ref = torch.cat([pipeline.render_fixed_fns(
            fns_k, o[s:s + 32768], d[s:s + 32768], acfg.ns_full)[0]
            for s in range(0, H * W, 32768)]).reshape(H, W, 3)
        assert abs(float(rendering.psnr(img_k, ref))
                   - float(rendering.psnr(img_p, ref))) <= 0.1


def _serve_engine(fields, acfg, device, caches=True, **kw):
    from repro_torch.serve import render_engine
    tiers = dict(
        reuse=framecache.ProbeReuseConfig(refresh_every=0),
        radiance=framecache.RadianceReuseConfig(refresh_every=0),
        scenecache=scenecache.SceneCacheConfig(byte_budget=8 << 20)
    ) if caches else dict(reuse=None)
    return render_engine.RenderServingEngine(
        fields, acfg, render_engine.RenderServeConfig(
            blocks_per_batch=4, slots=2, **tiers, **kw), device=device)


def test_serve_worker_streams_are_deterministic(cuda):
    """The serving engine on the kernel field (fused march) at a small
    size: with every reuse tier on, frames and deterministic counters are
    bit-identical with the Stage-A probes inline and on two worker streams
    beside the march; with the tiers off, two batches in flight change
    nothing either, and a request's frame equals render_asdr_image's.
    (With the tiers on, batches in flight move when frames finish and so
    what later admissions find cached, in the reference as here.  Both
    scenes are kernel fields: the fused march gives a block the same rows
    whatever shares its launch, the plain field's matmuls need not.)"""
    from repro_torch.serve import render_engine
    from repro_torch.serve.stats import DETERMINISTIC_COUNTERS
    bundle = ingp_asdr.SMOKE
    acfg = dataclasses.replace(bundle.asdr, march_backend="fused")
    fields = {name: ops.field_fns(params.from_jax_params(
        params.random_params(bundle.model, seed, 30.0), bundle.model,
        device=cuda)) for name, seed in (("a", 8), ("b", 9))}

    def reqs():
        return [render_engine.RenderRequest(
            rid=i, scene="ab"[i % 2], cam=scene.look_at_camera(
                40, 40, theta=0.9 + 0.05 * (i // 2 % 3), phi=0.55))
            for i in range(12)]

    def run(caches, **kw):
        eng = _serve_engine(fields, acfg, cuda, caches, **kw)
        ops.reset_launch_counts()
        done = {r.rid: r for r in eng.render(reqs())}
        out = (done, eng.engine_stats(), ops.launch_counts())
        eng.close()
        return out

    for caches, variants in ((True, (dict(prefetch=2),
                                     dict(prefetch=2, workers=2))),
                             (False, (dict(inflight_batches=2),))):
        ref_done, ref_st, launches = run(caches, prefetch=0)
        assert launches["fused_march"] == ref_st["batches"] > 0
        assert launches["hash_encode"] > 0 and launches["color_mlp"] > 0
        for kw in variants:
            done, st, _ = run(caches, **kw)
            for rid in ref_done:
                assert np.array_equal(ref_done[rid].image,
                                      done[rid].image), kw
            for c in DETERMINISTIC_COUNTERS:
                assert st[c] == ref_st[c], (kw, c)
    img, _ = pipeline.render_asdr_image(fields["a"], acfg, reqs()[0].cam,
                                        device=cuda)
    assert np.array_equal(ref_done[0].image, img.cpu().numpy())


@pytest.mark.parametrize("n_real", [1, 3, 4])
def test_padded_batch_rows_equal_an_unpadded_launch(n_real, cuda):
    """The pool pads a partial batch with unit-budget dummy blocks (o = 0,
    d = +z): the real blocks' rows of the padded launch equal an
    unpadded launch of the real blocks alone, to the bit."""
    from repro_torch.serve import pool as pool_lib
    from repro_torch.serve.scheduler import DEFAULT_CLASS
    from repro_torch.serve.stats import EngineCounters
    bundle = ingp_asdr.SMOKE
    field = params.from_jax_params(params.random_params(bundle.model, 8, 30.0),
                                   bundle.model, device=cuda)
    acfg = dataclasses.replace(bundle.asdr, march_backend="fused")
    fns = ops.field_fns(field)
    cam = scene.look_at_camera(40, 40, theta=0.9, phi=0.55)
    o, d = scene.camera_rays(cam, device=cuda)
    counts, _ = pipeline.probe_phase(fns, acfg, cam, device=cuda)
    o, d, counts, _, _ = pipeline.pad_rays_to_blocks(acfg, o, d, counts)
    order, budgets = pipeline.block_sort(acfg, counts)
    B = acfg.block_size
    o_s, d_s = o[order].reshape(-1, B, 3), d[order].reshape(-1, B, 3)
    at = torch.arange(n_real, device=cuda)
    alone = ops.fused_march_blocks(fns.fused, acfg, o_s[at], d_s[at],
                                   budgets[at].to(torch.int32))

    class _Req:
        rid, scene, arrival_s, cls = 0, "a", 0.0, DEFAULT_CLASS

    class _Slot:
        req = _Req()
        rows = {}

        def deliver(self, bi, rgb, acc, depth, chunks, cached=False):
            self.rows[bi] = (rgb, acc, depth, chunks)

    slot = _Slot()
    pool = pool_lib.BlockPool(acfg, 4, None, EngineCounters())
    pool.items = [(slot, i, o_s[i], d_s[i], int(budgets[i]), None, None,
                   False) for i in range(n_real)]
    handle = pool.dispatch(lambda scene_id, dens: pool_lib.batched_march(
        fns, acfg, dens))
    assert handle[2] == 4 - n_real
    pool.collect(handle)
    for i in range(n_real):
        rgb, acc, depth, chunks = slot.rows[i]
        assert np.array_equal(rgb, alone[0][i].cpu().numpy())
        assert np.array_equal(acc, alone[1][i].cpu().numpy())
        assert np.array_equal(depth, alone[2][i].cpu().numpy())
        assert int(chunks) == int(alone[3][i])
