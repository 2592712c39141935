"""TensoRF VM fields on the port's ASDR frame, on the CPU at a small size:
the library-op field against the benchmark's plain reference
(``bench/reference/tensorf.py``), the VM march's plain version against
the reference march (``bench/reference/asdr.py``), the whole frame
against the reference frame, and four faults the comparison must catch.
The kernel itself runs only on the card (``test_torch_gpu.py``)."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import pipeline, scene
from repro_torch.core import tensorf
from repro_torch.kernels import ops
from repro_torch.kernels import vm_march as VM

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.metrics import _work_vm  # noqa: E402
from bench.reference import asdr as ref_asdr  # noqa: E402
from bench.reference import tensorf as ref_tensorf  # noqa: E402

SMALL = tensorf.TensoRFConfig(resolution=(16, 20, 24),
                              density_components=(2, 2, 2),
                              app_components=(4, 4, 4), app_dim=5, hidden=16)
# the density tensors' scale: products of N(0, 2) taps, so the feature
# spans softplus's knee at -density_shift and rays saturate
DENSITY_GAIN = 20.0
MARCH = dict(chunk=16, group=2)
BUDGETS = (8, 12, 16, 48)
BLOCK = 40                      # one whole unit of 32 rays and one of 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for this module: beside the suite's other
    workers its intra-op threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_dict(cfg: tensorf.TensoRFConfig, **asdr) -> dict:
    return {"tensorf": {"resolution": list(cfg.resolution),
                        "density_components": list(cfg.density_components),
                        "app_components": list(cfg.app_components),
                        "app_dim": cfg.app_dim, "fea_pe": cfg.fea_pe,
                        "view_pe": cfg.view_pe, "hidden": cfg.hidden,
                        "density_shift": cfg.density_shift,
                        "distance_scale": cfg.distance_scale,
                        "aabb_size": cfg.aabb_size},
            "asdr": asdr}


def make_params(cfg=SMALL, seed=0, device="cpu"):
    p = tensorf.init_tensorf(cfg, prng.PRNGKey(seed), device=device)
    for g in ("density_plane", "density_line"):
        p[g] = [t * DENSITY_GAIN for t in p[g]]
    return p


def rays(n, seed, device="cpu"):
    """Rays from a sphere of radius 1.2 around the cube towards its
    centre, jittered."""
    g = np.random.default_rng(seed)
    v = g.normal(size=(n, 3))
    o = 0.5 + 1.2 * v / np.linalg.norm(v, axis=1, keepdims=True)
    d = 0.5 + g.normal(0, 0.15, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32, device=device),
            torch.tensor(d, dtype=torch.float32, device=device))


def march_inputs(cfg=SMALL, budgets=BUDGETS, B=BLOCK, seed=1,
                 device="cpu"):
    """(params, VMTables, o (N*B, 3), d, budgets (N,))."""
    p = make_params(cfg, device=device)
    o, d = rays(len(budgets) * B, seed, device)
    return (p, VM.pack_tables(cfg, p), o, d,
            torch.tensor(budgets, dtype=torch.int32, device=device))


def plain_march(tb, o, d, budgets, B=BLOCK, **kw):
    kw = dict(MARCH, **kw)
    return VM.vm_march_plain(
        o, d, VM.view_features(d, tb.view_pe), budgets, tb, block_size=B,
        near=ops.NEAR32, far=ops.FAR32, log_eps_t=ops.LOG_EPS_T32, **kw)


def march_numbers(cfg=SMALL, **kw):
    """The plain VM march against the reference march on the reference
    field: (rgb max error, depth max error, chunks equal, ray chunks
    equal, anchors as counted, anchors as ``_work_vm`` reckons them)."""
    p, tb, o, d, bud = march_inputs(cfg)
    N, B = bud.shape[0], BLOCK
    out, anchors = plain_march(tb, o, d, bud, **kw)
    out = out.reshape(N, B, VM.OUT_W)
    field = ref_tensorf.Field(p, cfg_dict(cfg))
    rgb, depth, chunks, ray_chunks = ref_asdr.march_blocks(
        field, dict(MARCH, white_background=True), o.reshape(N, B, 3),
        d.reshape(N, B, 3), bud)
    err_rgb = (out[..., 1:4] - rgb).abs() / (1e-5 + 1e-4 * rgb.abs())
    err_depth = (out[..., 4] - depth).abs() / (1e-5 + 1e-4 * depth.abs())
    reckoned = _work_vm.march_counts(bud.tolist(), chunks.tolist(), B,
                                     MARCH["chunk"], MARCH["group"])[1]
    return (float(err_rgb.max()), float(err_depth.max()),
            torch.equal(out[:, 0, 5].to(torch.int32), chunks),
            torch.equal(out[..., 6].to(torch.int32), ray_chunks),
            int(anchors.sum()), reckoned, chunks)


def test_field_fns_match_the_reference():
    p = make_params()
    field = tensorf.TensoRFField(SMALL, p)
    fns = tensorf.field_fns(field)
    ref = ref_tensorf.Field(p, cfg_dict(SMALL))
    g = torch.Generator().manual_seed(3)
    pts = torch.rand((3000, 3), generator=g) * 1.4 - 0.2
    dirs = torch.nn.functional.normalize(torch.randn((3000, 3), generator=g),
                                         dim=-1)
    sigma, geo = fns.density(pts)
    want, _ = ref.density(pts)
    assert torch.equal(geo, pts)
    assert (sigma > 1.0).float().mean() > 0.02     # a field, not a fog
    torch.testing.assert_close(sigma, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(fns.color(pts, dirs), ref.color(pts, dirs),
                               rtol=1e-6, atol=1e-6)
    # the kernel's plain field functions, in its own order of sums
    torch.testing.assert_close(VM.density_plain(pts, VM.pack_tables(SMALL, p)),
                               want, rtol=1e-5, atol=1e-4)
    tb = VM.pack_tables(SMALL, p)
    torch.testing.assert_close(
        VM.appearance_plain(pts, VM.view_features(dirs, SMALL.view_pe), tb),
        ref.color(pts, dirs), rtol=1e-5, atol=1e-6)


def test_vm_march_plain_matches_the_reference_march():
    err_rgb, err_depth, same_chunks, same_rays, anchors, reckoned, chunks = \
        march_numbers()
    assert same_chunks and same_rays
    assert err_rgb <= 1.0 and err_depth <= 1.0
    assert anchors == reckoned
    # the blocks stop at their budgets or on saturating, not all at once
    assert 1 <= int(chunks.min()) < int(chunks.max())


def test_per_ray_exit_and_density_only_keep_the_counters():
    p, tb, o, d, bud = march_inputs()
    full, anc = plain_march(tb, o, d, bud)
    exit_, anc_exit = plain_march(tb, o, d, bud, per_ray_exit=True)
    dens, anc_dens = plain_march(tb, o, d, bud, with_color=False)
    assert torch.equal(full[:, 5], exit_[:, 5])
    assert torch.equal(full[:, 5], dens[:, 5])
    assert torch.equal(full[:, 0], dens[:, 0])
    assert int(anc_exit.sum()) <= int(anc.sum()) and int(anc_dens.sum()) == 0


def test_render_asdr_image_matches_the_reference_frame():
    p = make_params()
    acfg = pipeline.ASDRConfig(ns_full=32, probe_stride=4, block_size=64,
                               chunk=16, group=2, candidates=(8, 16),
                               march_backend="fused")
    cam = scene.look_at_camera(32, 32, 0.7, 0.5, radius=1.2,
                               center=(0.5, 0.5, 0.5))
    ops.reset_launch_counts()
    img, stats = pipeline.render_asdr_image(
        ops.tensorf_field_fns(tensorf.TensoRFField(SMALL, p)), acfg, cam,
        device="cpu")
    assert ops.launch_counts()["vm_march"] == 0      # the CPU: plain version
    a = {"ns_full": 32, "probe_stride": 4, "block_size": 64, "chunk": 16,
         "group": 2, "candidates": [8, 16], "delta": acfg.delta,
         "white_background": True}
    want, ref = ref_asdr.render_frame(ref_tensorf.Field(p, cfg_dict(SMALL)),
                                      cfg_dict(SMALL, **a), cam, "cpu")
    assert torch.equal(stats["counts"], ref["counts"])
    assert len(set(ref["counts"].tolist())) > 1
    assert torch.equal(stats["budgets"], ref["budgets"])
    assert torch.equal(stats["chunks_per_block"], ref["chunks_per_block"])
    assert torch.equal(stats["ray_chunks_per_block"],
                       ref["ray_chunks_per_block"])
    torch.testing.assert_close(img, want, rtol=1e-4, atol=1e-5)
    assert ops.vm_anchor_count() == _work_vm.march_counts(
        ref["budgets"].tolist(), ref["chunks_per_block"].tolist(), 64, 16,
        2)[1]


def _drop_line(real):
    def plane_line(*args):
        pv, lv = real(*args)
        return pv, torch.ones_like(lv)
    return plane_line


def _zero_biases(real):
    def weights(tb):
        wb, w1, b1, w2, b2, w3, b3 = real(tb)
        return wb, w1, b1 * 0, w2, b2 * 0, w3, b3 * 0
    return weights


@pytest.mark.parametrize("fault", ["line factor dropped", "PE dropped",
                                   "biases dropped",
                                   "appearance at every sample"])
def test_faults_in_the_march_are_caught(fault, monkeypatch):
    kw = {}
    if fault == "line factor dropped":
        monkeypatch.setattr(VM, "_plane_line", _drop_line(VM._plane_line))
    elif fault == "PE dropped":
        monkeypatch.setattr(VM, "positional_encoding",
                            lambda x, f: torch.zeros((x.shape[0],
                                                      2 * f * x.shape[1])))
    elif fault == "biases dropped":
        monkeypatch.setattr(VM, "chain_weights",
                            _zero_biases(VM.chain_weights))
    else:
        kw["group"] = 1
    err_rgb, err_depth, same_chunks, same_rays, anchors, reckoned, _ = \
        march_numbers(**kw)
    assert not (err_rgb <= 1.0 and err_depth <= 1.0 and same_chunks
                and same_rays and anchors == reckoned)
