"""The VM cell's harness pieces on the CPU at a tiny size: the cell added
as files runs and comes out correct, a traced run reads the VM work, the
fit is deterministic and the seed only reorders it, and the VM cell's
reference is not the program."""
import json
import time

import torch

from conftest import ROOT, add_cell

from bench import harness
from bench.inputs import field_tensorf
from bench.reference import tensorf as ref_tensorf

SEED = 2 ** 31 + 777
TINY_VM = {
    "name": "tiny-vm", "source": "test", "reduced": [], "assumed": [],
    "precision": "float32, TF32 off",
    "tensorf": {"resolution": [24, 24, 24], "density_components": [4, 4, 4],
                "app_components": [8, 8, 8], "app_dim": 5, "fea_pe": 2,
                "view_pe": 2, "hidden": 16, "density_shift": -10.0,
                "distance_scale": 25.0, "aabb_size": 3.0},
    "asdr": {"ns_full": 64, "probe_stride": 4, "delta": 0.00048828125,
             "candidates": [8, 16, 32], "group": 2, "block_size": 64,
             "chunk": 16, "early_termination": True,
             "white_background": True, "march_backend": "fused"},
    "image_hw": [40, 40],
    "fit": {"steps": 40, "points": 4096, "lr_grid": 0.02, "lr_net": 0.001,
            "density_eps": 0.001, "solid_sigma": 1.0, "color_weight": 1.0},
}


def vm_cell(root, name="tiny.tensorf-frames"):
    wl = json.loads((ROOT / "bench" / "workloads"
                     / "tensorf-vm.frames.json").read_text())
    add_cell(root, name, TINY_VM, "tensorf-frames",
             dict(wl, check={"frames": 2}), like="tensorf-vm.frames")
    return name


def test_vm_cell_added_as_files_runs_and_reads_its_work(bench_root):
    torch.set_num_threads(2)
    name = vm_cell(bench_root)
    result, rows = harness.execute(bench_root, name, SEED, 1.0, True,
                                   torch.device("cpu"), time.perf_counter())
    assert result["correct"], rows
    assert result["attempted"] >= 1 and result["failed"] == 0
    share = result["metrics"]["adaptive.sample_share"]["value"]
    assert 0 < share <= 100
    assert result["metrics"]["frame_mfu"]["value"] > 0
    # device readings need the card
    assert "tensorf.march_ms" not in result["metrics"]


def test_vm_fit_is_deterministic_and_the_seed_only_reorders_it():
    dev = torch.device("cpu")
    cfg = dict(TINY_VM, fit=dict(TINY_VM["fit"], steps=3))
    a = field_tensorf.fit(field_tensorf.init_params(cfg, dev), cfg, "lego",
                          dev)
    b = field_tensorf.fit(field_tensorf.init_params(cfg, dev), cfg, "lego",
                          dev)
    for k in a:
        for x, y in zip(a[k] if isinstance(a[k], list) else [a[k]],
                        b[k] if isinstance(b[k], list) else [b[k]]):
            assert torch.equal(x, y), k
    p1 = field_tensorf.arrange(a, cfg, 1, dev)
    p2 = field_tensorf.arrange(a, cfg, 2, dev)
    assert not torch.equal(p1["app_plane"][0], p2["app_plane"][0])
    pts = torch.rand((500, 3), generator=torch.Generator().manual_seed(0))
    dirs = torch.nn.functional.normalize(torch.randn((500, 3)), dim=-1)
    f1, f2 = ref_tensorf.Field(p1, cfg), ref_tensorf.Field(p2, cfg)
    torch.testing.assert_close(f1.density(pts)[0], f2.density(pts)[0],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f1.color(pts, dirs), f2.color(pts, dirs),
                               rtol=1e-5, atol=1e-6)


def test_density_controls_round_only_the_density_tensors():
    from bench.drivers import tensorf_frames as drv

    x = torch.randn((4096,), generator=torch.Generator().manual_seed(1))
    assert torch.equal(drv.round_mantissa(x, 7), x.bfloat16().float())
    big = x[x.abs() > 1e-4]
    assert torch.equal(drv.round_mantissa(big, 10), big.half().float())
    cfg = dict(TINY_VM, fit=dict(TINY_VM["fit"], steps=2))
    dev = torch.device("cpu")
    p = field_tensorf.arrange(field_tensorf.fit(
        field_tensorf.init_params(cfg, dev), cfg, "lego", dev), cfg, 1, dev)
    pts = torch.rand((500, 3), generator=torch.Generator().manual_seed(0))
    sig = ref_tensorf.Field(p, cfg).density(pts)[0]
    for control, bits in drv.DENSITY_CONTROLS.items():
        q = dict(p, **{k: [drv.round_mantissa(t, bits) for t in p[k]]
                       for k in ("density_plane", "density_line")})
        assert not torch.equal(ref_tensorf.Field(q, cfg).density(pts)[0],
                               sig), control
