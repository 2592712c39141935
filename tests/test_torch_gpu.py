"""The rebuilt kernels on the card: the hash encode, density, march and
volume-render kernels held to their plain versions bit for bit on small
inputs (the hash encode at ragged point counts, feature widths and level
counts, rows that are no power of two, a table off 8-B alignment), flash
attention within its tolerances (fp32 and bf16, window, softcap, GQA
ratios 1, 2 and 8, lengths off the tile grid, head widths up to 256,
gemma3-12b's GQA at head_dim 256), and the launchers asking for the
shared memory (and, for flash attention, the tiles, grid and key tiles
at both head-dim bounds) the wrappers reckon.  The LM smoke configs
(gemma2, gemma3, the MoE, SSM and hybrid families, paligemma, whisper)
on the kernel route against their plain builds.  LM training: the
kernels refusing inputs that require grad, smoke configs' train steps on
the training route against the CPU's, the token pipeline, compression
and checkpoints on the card.  Training steps on the card against the same steps on
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

from repro_torch import framecache, optim, params, prng, scenecache
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


@pytest.mark.parametrize("Dh", [16, 48, 80, 128, 144, 208, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_widths(dtype, Dh, cuda):
    rng = np.random.default_rng(Dh)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
               .to(cuda).to(dtype)
               for sh in ((1, 200, 4, Dh), (1, 200, 2, Dh), (1, 200, 2, Dh)))
    assert_attention_close(FA.flash_attention(q, k, v, 48, 0.0),
                           FA.flash_attention_plain(q, k, v, 48), dtype)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (100, 0.0),
                                            (0, 50.0), (1024, 0.0)])
@pytest.mark.parametrize("H,KV", [(16, 8), (8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dim_256(dtype, H, KV, window, softcap, cuda):
    """The head-dim-256 instantiations (gemma3-12b's GQA 16 / 8 and an MQA
    8 / 1) against the plain version, at a length off both tiles, with a
    window shorter and longer than it, and with the softcap."""
    rng = np.random.default_rng(H + KV + window)
    S, Dh = 1155, 256
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
               .to(cuda).to(dtype)
               for sh in ((1, S, H, Dh), (1, S, KV, Dh), (1, S, KV, Dh)))
    assert_attention_close(FA.flash_attention(q, k, v, window, softcap),
                           FA.flash_attention_plain(q, k, v, window, softcap),
                           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_launcher_uses_the_reckoned_tiles(dtype, cuda):
    for Dh, S in ((128, 8192), (64, 333), (16, 1), (256, 4608), (144, 333),
                  (256, 1)):
        assert FA.launch_config(Dh, 2, S, 8, dtype) == (
            *FA.tiles(Dh, dtype), FA.smem_bytes(Dh, dtype),
            *FA.grid(2, S, 8, Dh, dtype))


DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
KEY_TILE_CASES = [(dtype, S, window) for dtype in DTYPES
                  for S in (200, 333, 512) for window in (0, 1, 48, 100, 130)]


def direct_key_tiles(S, window, dt, Dh=128):
    """{first row of each query tile: first keys of the key tiles holding an
    unmasked (query, key) pair of its rows}, counted pair by pair, at the
    tiles of head_dim ``Dh``."""
    qb, kb = FA.tiles(Dh, dt)
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
        assert list(FA.launched_key_tiles(q0, S, window, 128, dt)) == tiles, q0


@pytest.mark.parametrize("dtype,S,window", KEY_TILE_CASES)
def test_flash_kernel_key_tiles_at_head_dim_256(dtype, S, window, cuda):
    """The same at the head-dim-256 instantiations' tiles."""
    dt = DTYPES[dtype]
    for q0, tiles in direct_key_tiles(S, window, dt, 256).items():
        assert list(FA.launched_key_tiles(q0, S, window, 256, dt)) == tiles, q0


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
    params = model.init_ngp(TRAIN_MODEL, prng.PRNGKey(0), device=cpu)
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
    init = model.init_ngp(TRAIN_MODEL, prng.split(prng.PRNGKey(
        TRAIN_CFG.seed))[1], device=cuda)
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


def _placed_cards(monkeypatch, cuda):
    """(cards, one_card): ``cuda:1`` .. where the host has them, else the
    engine's own card through the ``_available_devices`` hook."""
    from repro_torch.serve import executor as executor_lib
    cards = executor_lib._available_devices()[1:]
    if cards:
        return cards, False
    card = executor_lib.indexed(cuda)
    monkeypatch.setattr(executor_lib, "_available_devices",
                        lambda: [card, card])
    return [card], True


def _smoke_serve_fields(cuda):
    bundle = ingp_asdr.SMOKE
    acfg = dataclasses.replace(bundle.asdr, march_backend="fused")
    return acfg, {name: ops.field_fns(params.from_jax_params(
        params.random_params(bundle.model, seed, 30.0), bundle.model,
        device=cuda)) for name, seed in (("a", 8), ("b", 9))}


def _smoke_serve_requests(offset=0):
    from repro_torch.serve import render_engine
    return [render_engine.RenderRequest(
        rid=offset + i, scene="ab"[i % 2], cam=scene.look_at_camera(
            40, 40, theta=0.9 + 0.05 * (i // 2 % 3), phi=0.55))
        for i in range(12)]


def test_serve_stage_a_placed_on_replicas(monkeypatch, cuda):
    """Stage A through a DeviceExecutor on the kernel field (``devices``
    > 0): on ``cuda:1`` .. where the host has them, else on the engine's
    own card with every Stage A on a replica of its field built there
    (the replicas' home named off the card).  Frames and deterministic
    counters equal a sync prefetch-2 run's, each placed Stage A ran with
    its card current, the replicas hold their own copy of the tables, and
    every tensor a taken speculation hands Stage B lies on the engine's
    card."""
    from repro_torch.serve import admission
    from repro_torch.serve import executor as executor_lib
    from repro_torch.serve.stats import DETERMINISTIC_COUNTERS
    acfg, fields = _smoke_serve_fields(cuda)
    ref_eng = _serve_engine(fields, acfg, cuda, prefetch=2)
    ref = {r.rid: r for r in ref_eng.render(_smoke_serve_requests())}
    ref_st = ref_eng.engine_stats()
    ref_eng.close()

    cards, one_card = _placed_cards(monkeypatch, cuda)
    eng = _serve_engine(fields, acfg, cuda, prefetch=2, devices=len(cards))
    assert isinstance(eng.executor, executor_lib.DeviceExecutor)
    if one_card:
        eng.replicas.device = torch.device("meta")
    real_prepare, real_take = admission.prepare, eng.executor.take
    placed, taken = [], []

    def prepare(engine, req):
        if executor_lib.placement() is not None:
            placed.append((executor_lib.placement(),
                           torch.cuda.current_device()))
        return real_prepare(engine, req)

    def take(key):
        out = real_take(key)
        if out is not None:
            taken.extend(t.device for t in out.tensors() if t is not None)
        return out

    monkeypatch.setattr(admission, "prepare", prepare)
    monkeypatch.setattr(eng.executor, "take", take)
    done = {r.rid: r for r in eng.render(_smoke_serve_requests())}
    st, built = eng.engine_stats(), dict(eng.replicas.built)
    eng.close()
    for rid in ref:
        assert np.array_equal(ref[rid].image, done[rid].image), rid
    for c in DETERMINISTIC_COUNTERS:
        assert st[c] == ref_st[c], c
    assert placed and all(p in cards and cur == p.index for p, cur in placed)
    assert taken and all(d == eng.device for d in taken)
    assert built and all(
        r.fused.tables.data_ptr() != fields[sc].fused.tables.data_ptr()
        and r.fused.tables.device == c for (sc, c), r in built.items())


def test_two_serve_replicas_over_one_sharded_store(monkeypatch, cuda):
    """Two placed engine replicas over one ShardedSceneCache on the kernel
    field, the second replaying the first's requests: every frame
    bit-equal to a plain sync engine's, the second replica's blocks from
    the store, every shard within its budget."""
    from repro_torch.serve import render_engine
    acfg, fields = _smoke_serve_fields(cuda)
    plain = _serve_engine(fields, acfg, cuda, caches=False, prefetch=0)
    ref = {r.rid: r for r in plain.render(_smoke_serve_requests())}
    plain.close()
    cards, _ = _placed_cards(monkeypatch, cuda)
    shared = scenecache.ShardedSceneCache(
        scenecache.SceneCacheConfig(byte_budget=8 << 20), shards=4)
    engines = [render_engine.RenderServingEngine(
        fields, acfg, render_engine.RenderServeConfig(
            blocks_per_batch=4, slots=2, reuse=None, radiance=None,
            devices=len(cards)), scenecache=shared, device=cuda)
        for _ in range(2)]
    done = [engines[k].render(_smoke_serve_requests(100 * k))
            for k in range(2)]
    hits = engines[1].engine_stats()["scene_block_hits"]
    st = shared.stats()
    for eng in engines:
        eng.close()
    shared.close()
    for frames in done:
        for r in frames:
            assert np.array_equal(r.image, ref[r.rid % 100].image), r.rid
    assert hits > 0
    assert all(b <= st["per_shard_budget"]
               for b in st["per_shard_resident_bytes"])


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


def test_prng_draws_on_the_card_equal_the_cpu(cuda):
    """``repro_torch.prng`` gives the same bits on the card as on the CPU:
    bits, uniform and randint (and so the inits, batches and probe draws),
    normal and categorical, across a chunk boundary."""
    key = prng.fold_in(prng.PRNGKey(17), 3)
    n = prng.CHUNK + 4099
    for fn in (lambda dev: prng.bits(key, (n,), dev),
               lambda dev: prng.uniform(key, (n,), minval=-3.5, maxval=7.25,
                                        device=dev),
               lambda dev: prng.randint(key, (5001,), -5, 2 ** 24 + 17,
                                        device=dev),
               lambda dev: prng.normal(key, (n,), device=dev),
               lambda dev: prng.gumbel(key, (64, 1000), dev)):
        assert torch.equal(fn(cuda).cpu(), fn("cpu"))
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 256000)).astype(np.float32))
    assert torch.equal(prng.categorical(key, logits.to(cuda)).cpu(),
                       prng.categorical(key, logits))
    out = torch.empty((3000, 700), dtype=torch.bfloat16, device=cuda)
    prng.normal_into(out, key, 0.02)
    assert torch.equal(out.cpu(), (prng.normal(key, (3000, 700)) * 0.02).to(
        torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_lm_kernel_build_matches_plain(dtype, cuda):
    """gemma2's smoke config built on the flash kernel against the same
    weights built on ``flash_attention_plain``: prefill logits within
    atol 1e-3 (float32) or 5e-2 (bf16), every decode step's logits too,
    and (float32) the greedy tokens equal."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve import engine
    cfg = dataclasses.replace(configs.get_smoke("gemma2_27b"), dtype=dtype)
    kern = lm.build(cfg, device=cuda)
    plain = lm.build(cfg, device=cuda, attention=FA.flash_attention_plain)
    values = kern.init(prng.PRNGKey(0), dtype=getattr(torch, dtype))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 40)))
    atol = 1e-3 if dtype == "float32" else 5e-2
    ops.reset_launch_counts()
    lk, ck = kern.prefill_fn(values, {"tokens": toks}, max_seq=48)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    lp, cp = plain.prefill_fn(values, {"tokens": toks}, max_seq=48)
    torch.testing.assert_close(lk, lp, rtol=0, atol=atol)
    tok = torch.argmax(lp[:, -1], dim=-1)[:, None]
    for pos in range(40, 46):
        sk, ck = kern.decode_fn(values, ck, tok, pos)
        sp, cp = plain.decode_fn(values, cp, tok, pos)
        torch.testing.assert_close(sk, sp, rtol=0, atol=atol)
        tok = torch.argmax(sp[:, 0], dim=-1)[:, None]
    if dtype == "float32":
        reqs = [engine.Request(rid=i, prompt=toks[i].numpy(), max_new=6)
                for i in range(2)]
        outs = [{r.rid: r.out for r in engine.ServingEngine(
            api, values, engine.ServeConfig(max_seq=48), device=cuda)
            .generate([dataclasses.replace(r) for r in reqs])}
            for api in (kern, plain)]
        for rid in outs[0]:
            np.testing.assert_array_equal(outs[0][rid], outs[1][rid])


def test_build_refuses_a_head_dim_beyond_the_kernel(cuda):
    """On the card the default route is the flash kernel or nothing:
    gemma3-12b's head_dim 256 takes the kernel; a head_dim past 256 raises
    at build time; a build that passes the plain function explicitly goes
    on."""
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get("gemma3-12b")
    assert lm.build(cfg, device=cuda).attention == "flash_attention"
    wide = dataclasses.replace(cfg, head_dim=288)
    with pytest.raises(NotImplementedError, match="head_dim 288"):
        lm.build(wide, device=cuda)
    plain = lm.build(wide, device=cuda, attention=FA.flash_attention_plain)
    assert plain.attention == "flash_attention_plain"


@pytest.mark.parametrize("G,S,E,k,C,kind", [
    (4, 1024, 64, 6, 120, "random"), (4, 512, 64, 6, 60, "random"),
    (4, 1, 64, 6, 1, "random"), (2, 64, 8, 2, 20, "tied"),
    (3, 128, 64, 6, 30, "tied"), (2, 64, 64, 6, 5, "overflow")])
def test_moe_route_on_the_card_equals_the_cpu(G, S, E, k, C, kind, cuda):
    """``ffn._route`` on the card gives the CPU's dispatch and combine bit
    for bit (its softmax is XLA's exp and reduce order in exact ops, its
    top-k a stable sort), ties and capacity overflow included."""
    from repro_torch.models import ffn
    rng = np.random.default_rng(0)
    if kind == "random":
        x = rng.standard_normal((G, S, E)) * 2
    elif kind == "tied":
        x = rng.integers(-2, 3, (G, S, E))
    else:                                   # every token picks expert 0
        x = np.zeros((G, S, E))
        x[..., 0] = 10.0
    x = torch.from_numpy(x.astype(np.float32))
    want = ffn._route(x, k, C)
    got = ffn._route(x.to(cuda), k, C)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(ffn.softmax_f32(x.to(cuda)).cpu(), ffn.softmax_f32(x))


@pytest.mark.parametrize("arch,S,chunk", [("mamba2_780m", 512, 256),
                                          ("hymba_1_5b", 512, 256),
                                          ("mamba2_780m", 96, 32)])
def test_ssd_scan_on_the_card_matches_the_cpu(arch, S, chunk, cuda):
    """``ssm.ssd_scan`` at a full config's head widths (mamba2-780m: H 48,
    P 64, N 128; hymba-1.5b: H 50, P 64, N 16) within 1e-4 of the CPU's,
    output and final state, relative to each tensor's largest magnitude:
    a chunk's sums run over 256 tokens x 128 states, in another order on
    each device, and an output near 0 keeps the error of its terms."""
    from repro_torch import configs
    from repro_torch.models import ssm
    cfg = configs.get(arch)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((1, S, H, P)),
        rng.standard_normal((1, S, 1, N)) * 0.5,
        rng.standard_normal((1, S, 1, N)) * 0.5,
        np.log1p(np.exp(rng.standard_normal((1, S, H)))),
        -np.exp(np.linspace(-1.0, 1.0, H)), rng.uniform(0.5, 1.5, H))]
    want = ssm.ssd_scan(*args, chunk)
    got = ssm.ssd_scan(*(a.to(cuda) for a in args), chunk)
    for g, w in zip(got, want):
        err = float((g.cpu() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (err, float(w.abs().max()))


def test_new_families_build_on_the_kernel_route(cuda):
    """deepseek-moe-16b (head_dim 128) and hymba-1.5b (64) take the flash
    kernel on the card; mamba2-780m has no attention layer and still names
    the route."""
    from repro_torch import configs
    from repro_torch.models import lm
    for arch in ("deepseek-moe-16b", "hymba-1.5b", "mamba2-780m"):
        assert lm.build(configs.get(arch), device=cuda).attention == \
            "flash_attention"


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "hymba_1_5b",
                                  "mamba2_780m", "gemma3_12b"])
def test_smoke_new_families_kernel_build_matches_plain(arch, cuda):
    """The MoE, hybrid and SSM smoke configs (float32; the MoE at
    capacity_factor 8) on the flash kernel against the plain build on the
    same weights: prefill logits and six decode steps within atol 1e-3,
    the kernel launched once a layer with attention."""
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32",
                              capacity_factor=8.0)
    kern = lm.build(cfg, device=cuda)
    plain = lm.build(cfg, device=cuda, attention=FA.flash_attention_plain)
    values = kern.init(prng.PRNGKey(0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 40)))
    ops.reset_launch_counts()
    lk, ck = kern.prefill_fn(values, {"tokens": toks}, max_seq=48)
    assert ops.launch_counts()["flash_attention"] == (
        0 if cfg.family == "ssm" else cfg.n_layers)
    lp, cp = plain.prefill_fn(values, {"tokens": toks}, max_seq=48)
    torch.testing.assert_close(lk, lp, rtol=0, atol=1e-3)
    tok = torch.argmax(lp[:, -1], dim=-1)[:, None]
    for pos in range(40, 46):
        sk, ck = kern.decode_fn(values, ck, tok, pos)
        sp, cp = plain.decode_fn(values, cp, tok, pos)
        torch.testing.assert_close(sk, sp, rtol=0, atol=1e-3)
        tok = torch.argmax(sp[:, 0], dim=-1)[:, None]


def test_smoke_vlm_kernel_build_matches_plain(cuda):
    """paligemma's smoke config (float32) on the kernel route against the
    plain build on the same weights and image prefix: every layer carries
    the prefix mask, so neither prefill calls its route (no flash launch)
    and the logits are equal; decode after the prefix as well."""
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = dataclasses.replace(configs.get_smoke("paligemma_3b"),
                              dtype="float32")
    kern = lm.build(cfg, device=cuda)
    plain = lm.build(cfg, device=cuda, attention=FA.flash_attention_plain)
    values = kern.init(prng.PRNGKey(0))
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40))),
             "img_embeds": torch.from_numpy(rng.standard_normal(
                 (2, cfg.prefix_tokens, cfg.d_model), dtype=np.float32))}
    S = cfg.prefix_tokens + 40
    ops.reset_launch_counts()
    lk, ck = kern.prefill_fn(values, batch, max_seq=S + 6)
    assert ops.launch_counts()["flash_attention"] == 0
    lp, cp = plain.prefill_fn(values, batch, max_seq=S + 6)
    assert torch.equal(lk, lp)
    tok = torch.argmax(lp[:, -1], dim=-1)[:, None]
    for pos in range(S, S + 6):
        sk, ck = kern.decode_fn(values, ck, tok, pos)
        sp, cp = plain.decode_fn(values, cp, tok, pos)
        assert torch.equal(sk, sp)
        tok = torch.argmax(sp[:, 0], dim=-1)[:, None]


def test_smoke_encdec_kernel_build_matches_plain(cuda):
    """whisper's smoke config (float32): ``prefill_fn`` on the kernel route
    (one flash launch a decoder layer) against the plain build, logits
    within atol 1e-3 and the encoder output and cross K/V equal; then the
    token-by-token decode from position 0 over the cross K/V, whose last
    logits match ``decode_train``'s."""
    from repro_torch import configs
    from repro_torch.models import encdec, lm
    cfg = dataclasses.replace(configs.get_smoke("whisper_medium"),
                              dtype="float32")
    kern = lm.build(cfg, device=cuda)
    plain = lm.build(cfg, device=cuda, attention=FA.flash_attention_plain)
    values = kern.init(prng.PRNGKey(0))
    rng = np.random.default_rng(2)
    S = 24
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, S))),
             "frames": torch.from_numpy(rng.standard_normal(
                 (2, cfg.encoder_seq, cfg.d_model), dtype=np.float32))}
    ops.reset_launch_counts()
    lk, (ek, ckk, cvk) = kern.prefill_fn(values, batch)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    lp, (ep, ckp, cvp) = plain.prefill_fn(values, batch)
    torch.testing.assert_close(lk, lp, rtol=0, atol=1e-3)
    assert torch.equal(ek, ep) and torch.equal(ckk, ckp) and \
        torch.equal(cvk, cvp)
    cache = encdec.init_cache(cfg, 2, S, torch.float32, cuda)._replace(
        cross_k=ckk, cross_v=cvk)
    for pos in range(S):
        step, cache = kern.decode_fn(values, cache,
                                     batch["tokens"][:, pos:pos + 1], pos)
    torch.testing.assert_close(step[:, 0], lk[:, -1], rtol=0, atol=1e-3)


def test_kernels_refuse_inputs_that_require_grad(cuda):
    """The kernels have no backward: the flash wrapper raises for a CUDA
    input that requires grad while autograd records (so does a loss on the
    kernel route), and runs under no_grad."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.train.step import make_loss_and_grads
    q = torch.randn((1, 40, 4, 64), device=cuda, requires_grad=True)
    kv = torch.randn((1, 40, 2, 64), device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, kv, kv)
    with torch.no_grad():
        ops.flash_attention(q, kv, kv)
    cfg = configs.get_smoke("hymba_1_5b")
    api = lm.build(cfg, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))
    with pytest.raises(RuntimeError, match="no backward"):
        make_loss_and_grads(api.loss_fn, 1)(api.init(prng.PRNGKey(0)),
                                            {"tokens": toks})


@pytest.mark.parametrize("arch", ["minitron_8b", "hymba_1_5b",
                                  "deepseek_moe_16b"])
def test_lm_train_steps_on_the_card_match_the_cpu(arch, cuda):
    """Three ``make_train_step`` steps of a decoder smoke config (float32,
    the training route, remat "full" on the card, none on the CPU) on the
    card against the CPU: metrics within rtol 1e-4, params within atol
    1e-5, every gradient leaf of the first step nonzero where the CPU's
    is."""
    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.models import attention, lm
    from repro_torch.train.step import (TrainConfig, make_loss_and_grads,
                                        make_train_step)
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32",
                              capacity_factor=8.0)
    apis = {d: lm.build(cfg, remat_policy="full" if d == cuda else None,
                        attention=attention.attend_causal, device=d)
            for d in (cuda, torch.device("cpu"))}
    res = {}
    for dev, api in apis.items():
        values = api.init(prng.PRNGKey(0))
        pipe = TokenPipeline(vocab=cfg.vocab, batch=8, seq_len=32, device=dev)

        def batch(i):
            return {"tokens": pipe.batch_at(i)}
        _, g = make_loss_and_grads(api.loss_fn, 1)(values, batch(0))
        step_fn, init = make_train_step(api.loss_fn, TrainConfig(
            lr=3e-3, warmup_steps=2, total_steps=30))
        opt, ms = init(values), []
        for i in range(3):
            values, opt, m = step_fn(values, opt, batch(i), i)
            ms.append({k: float(v) for k, v in m.items()})
        res[dev.type] = (ms, [v.cpu() for v in optim.tree_leaves(values)],
                         [x.cpu() for x in optim.tree_leaves(g)])
    (m_d, v_d, g_d), (m_h, v_h, g_h) = res["cuda"], res["cpu"]
    for a, b in zip(m_d, m_h):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6)
    for a, b in zip(v_d, v_h):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    for a, b in zip(g_d, g_h):
        assert bool(a.abs().max() > 0) == bool(b.abs().max() > 0)


def test_encdec_loss_and_grads_on_the_card_match_the_cpu(cuda):
    """whisper's smoke config (float32, the training route, remat "full"
    on the card): the loss within rtol 1e-4 of the CPU's and each
    gradient leaf within 5e-3 of its max abs, none zero on the card alone
    (its conditioning: ``test_torch_lm_train.py``)."""
    from repro_torch import configs
    from repro_torch.models import attention, lm
    from repro_torch.train.step import make_loss_and_grads
    cfg = dataclasses.replace(configs.get_smoke("whisper_medium"),
                              dtype="float32")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (8, 32))),
             "frames": torch.from_numpy(rng.standard_normal(
                 (8, cfg.encoder_seq, cfg.d_model), dtype=np.float32))}
    out = []
    for dev, remat in ((cuda, "full"), (torch.device("cpu"), None)):
        api = lm.build(cfg, remat_policy=remat,
                       attention=attention.attend_causal, device=dev)
        loss, g = make_loss_and_grads(api.loss_fn, 1)(
            api.init(prng.PRNGKey(0)),
            {k: v.to(dev) for k, v in batch.items()})
        out.append((float(loss), [x.cpu() for x in optim.tree_leaves(g)]))
    (l_d, g_d), (l_h, g_h) = out
    np.testing.assert_allclose(l_d, l_h, rtol=1e-4)
    for a, b in zip(g_d, g_h):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 5e-3 * scale
        assert bool(a.abs().max() > 0) == (scale > 0)


def test_token_pipeline_and_compression_on_the_card_equal_the_cpu(cuda):
    """``TokenPipeline`` hands the CPU's tokens to the card;
    ``int8_compress`` / ``ErrorFeedback.apply`` on the card equal the
    CPU's bit for bit (every divisor is a device tensor)."""
    from repro_torch.data import TokenPipeline
    kw = dict(vocab=256_000, batch=4, seq_len=512, seed=2)
    assert torch.equal(TokenPipeline(**kw, device=cuda).batch_at(1).cpu(),
                       TokenPipeline(**kw, device="cpu").batch_at(1))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (37, 300)).astype(np.float32) * 1e-2)
    for a, b in zip(optim.int8_compress(x.to(cuda)), optim.int8_compress(x)):
        assert a == b if isinstance(a, int) else torch.equal(a.cpu(), b)
    g = {"w": x, "b": [x[0]]}
    out_d = optim.ErrorFeedback.apply(optim.tree_map(lambda t: t.to(cuda), g),
                                      optim.ErrorFeedback.init(
                                          optim.tree_map(lambda t: t.to(cuda),
                                                         g)))
    out_h = optim.ErrorFeedback.apply(g, optim.ErrorFeedback.init(g))
    for a, b in zip(optim.tree_leaves(out_d), optim.tree_leaves(out_h)):
        assert torch.equal(a.cpu(), b)


def test_checkpoint_of_card_tensors_restores_on_the_card(cuda, tmp_path):
    """A (values, AdamW state) of card tensors, bf16 leaves included,
    written asynchronously and restored on the card, leaf for leaf."""
    from repro_torch.ckpt import CheckpointManager
    tree = ({"w": torch.randn((64, 32), device=cuda),
             "h": torch.randn((8,), device=cuda).to(torch.bfloat16)},
            {"count": torch.ones((), dtype=torch.int32, device=cuda)})
    mgr = CheckpointManager(tmp_path, keep=1)
    mgr.save(3, tree)
    got, step = mgr.restore(optim.tree_map(torch.zeros_like, tree))
    assert step == 3
    for a, b in zip(optim.tree_leaves(got), optim.tree_leaves(tree)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_card_mesh_render_cell_matches_the_plain_field(cuda):
    """The dry-run's asdr_render cell on the card mesh (a 64x64 frame: one
    block of 4,096 rays, Phase I counts) renders through the kernel field
    and matches the plain field's march of the same sorted block: rgb and
    acc within rtol 1e-4 / atol 1e-5, chunk counters exact."""
    from repro_torch.launch import asdr_steps, mesh
    bundle = ingp_asdr.CONFIG
    field = params.from_jax_params(
        params.random_params(bundle.model, 8, 30.0), bundle.model,
        device=cuda)
    step, _, _ = asdr_steps.build_render_cell(bundle, mesh.make_card_mesh())
    cam = scene.look_at_camera(64, 64, theta=0.9, phi=0.55)
    fns = ops.field_fns(field)
    o, d, counts = asdr_steps.render_inputs(fns, bundle, cam, device=cuda)
    ops.reset_launch_counts()
    rgb, acc, stats = step(field.params(), o, d, counts)
    assert all(ops.launch_counts()[k] > 0
               for k in ("hash_encode", "density_mlp", "color_mlp"))
    acfg = dataclasses.replace(bundle.asdr,
                               block_size=asdr_steps.RENDER_BLOCK)
    order, budgets = pipeline.block_sort(acfg, counts)
    order = order.long()
    want = pipeline._march_block(model.field_fns(field), acfg,
                                 o[order][None], d[order][None], budgets)
    torch.testing.assert_close(rgb[order], want[0][0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(acc[order], want[1][0], rtol=1e-4, atol=1e-5)
    assert torch.equal(stats["chunks_per_block"], want[3])
    assert torch.equal(stats["ray_chunks_per_block"], want[4])


def test_device_span_encloses_its_kernel_on_the_profilers_clock(cuda):
    """A ``device=True`` span around a ``torch.cuda._sleep`` launch (its
    ``spin_kernel``) and the wait for it, recorded under the profiler with no tracer installed:
    its export on the Unix clock encloses the kernel's profiler interval
    within 50 us, and its ``device_ms`` (CUDA events on the stream) is at
    least the kernel's time, less the events' 1 us resolution."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with obs.span("sleep", device=True):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
    tr = obs.profiled()
    (sp,) = [s for s in tr.spans if s.name == "sleep"]
    ev = obs.export.chrome_trace([sp], t_origin=tr.export_origin())[
        "traceEvents"][-1]
    (k,) = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() != DeviceType.CPU and "spin" in e.name()]
    lo, hi = k.start_ns() / 1e3, (k.start_ns() + k.duration_ns()) / 1e3
    assert ev["ts"] - 50.0 <= lo and hi <= ev["ts"] + ev["dur"] + 50.0
    assert sp.attrs["device_ms"] >= k.duration_ns() / 1e6 - 1e-3
    assert obs.span("sleep", device=True) is obs.NULL_SPAN


# ---- the VM march (TensoRF fields) -----------------------------------------

@pytest.mark.parametrize("mode", ["color", "per_ray_exit", "density_only"])
@pytest.mark.parametrize("widths", ["small", "vm-192"])
def test_vm_march_matches_plain(widths, mode, cuda):
    """The VM march kernel against its plain version on the card, bit for
    bit (rows and per-block anchors): small widths at ragged blocks of 40
    rays and chunk 16, and VM-192's widths at a 48^3 grid with the frame's
    chunk 32 and every rung of the ladder."""
    from repro_torch.core import tensorf
    from repro_torch.kernels import vm_march as VM
    import test_torch_tensorf as T

    if widths == "small":
        cfg = tensorf.TensoRFConfig(resolution=(16, 20, 24),
                                    density_components=(4, 4, 4),
                                    app_components=(8, 8, 8), app_dim=5,
                                    hidden=16)
        budgets, B, march = T.BUDGETS, T.BLOCK, T.MARCH
    else:
        cfg = tensorf.TensoRFConfig(resolution=(48, 48, 48))
        budgets, B, march = (12, 24, 48, 96, 192, 12), 100, dict(chunk=32,
                                                                  group=2)
    _, tb, o, d, bud = T.march_inputs(cfg, budgets, B, device=cuda)
    view = None if mode == "density_only" else VM.view_features(d, tb.view_pe)
    kw = dict(block_size=B, near=ops.NEAR32, far=ops.FAR32,
              log_eps_t=ops.LOG_EPS_T32, with_color=mode != "density_only",
              per_ray_exit=mode == "per_ray_exit", **march)
    before = ops.launch_counts()["vm_march"]
    total = ops.vm_anchor_count()
    got = VM.vm_march(o, d, view, bud, tb, **kw)
    assert ops.launch_counts()["vm_march"] == before + 1
    want = VM.vm_march_plain(o, d, view, bud, tb, **kw)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert ops.vm_anchor_count() == total + int(want[1].sum())
