"""The benchmark's harness on the CPU at a tiny size: a cell added as new
files runs, the fit is deterministic, a result line has the contract's
keys, the work reckoning repeats the smoke's, and a broken timed path
comes out not correct."""
import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY_CONFIG, add_cell

from bench import harness
from bench.inputs import field as field_lib
from bench.inputs import poses as poses_lib
from bench.inputs import scenes
from bench.metrics import _work
from bench.reference import ngp

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}
# A serve mix small enough for the CPU: one scene, two viewers.
TINY_JUMP = {"driver": "serve", "scenes": ["lego"],
             "viewers_per_scene": 2, "radius": 1.2,
             "theta": [0.0, 6.283185307179586], "phi": [0.2, 1.0],
             "phi_sampling": "sphere", "cycle": 2,
             "engine": {"slots": 2, "blocks_per_batch": 4, "prefetch": 2,
                        "workers": 0, "store_mib": 16},
             "tiers": ["probe", "radiance", "scene"], "fresh_within": 150}
SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def frames_cell(root, name="tiny.frames"):
    wl = json.loads((ROOT / "bench" / "workloads"
                     / "ingp-asdr.frames.json").read_text())
    add_cell(root, name, TINY_CONFIG, "frames", dict(wl, check={"frames": 2}),
             like="ingp-asdr.frames")
    return name


def serve_cell(root, name="tiny.serve-jump"):
    wl = json.loads((ROOT / "bench" / "workloads"
                     / "ingp-asdr.serve-jump.json").read_text())
    add_cell(root, name, TINY_CONFIG, "tiny-jump",
             dict(wl, check={"frames": 2}), like="ingp-asdr.serve-jump",
             traffic_params=TINY_JUMP)
    return name


def run_cell(root, name, seconds=1.0, trace=False):
    result, rows = harness.execute(root, name, SEED, seconds, trace,
                                   torch.device("cpu"), time.perf_counter())
    json.loads(json.dumps(result))         # one JSON line
    return result, rows


def test_frames_cell_added_as_files_runs(bench_root):
    result, rows = run_cell(bench_root, frames_cell(bench_root))
    assert RESULT_KEYS <= set(result) and result["correct"]
    assert list(result)[-1] == "checked"
    assert {"frames_per_s", "frame_ms_p95", "setup_s"} == set(result["metrics"])
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert [k for k, _, _ in rows] == list(
        json.loads((ROOT / "bench" / "workloads"
                    / "ingp-asdr.frames.json").read_text())["limits"])


def test_serve_cell_added_as_files_runs(bench_root):
    result, _ = run_cell(bench_root, serve_cell(bench_root))
    assert RESULT_KEYS <= set(result) and result["correct"]
    assert {"serve_frames_per_s", "serve_latency_ms_p95",
            "setup_s"} == set(result["metrics"])
    assert result["attempted"] >= 2 and result["failed"] == 0


def test_traced_run_reads_the_counters(bench_root):
    result, _ = run_cell(bench_root, frames_cell(bench_root), trace=True)
    share = result["metrics"]["adaptive.sample_share"]["value"]
    assert 0 < share <= 100
    # device readings need the card: no CPU number under their names
    assert "pipeline.march_ms" not in result["metrics"]


def test_a_metric_added_as_a_file_is_read(bench_root):
    name = frames_cell(bench_root)
    (bench_root / "bench" / "metrics" / "frames_seen.py").write_text(
        "def read(obs):\n    return obs['frames']\n")
    bench = json.loads((bench_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "frames_per_s",
                               "workloads": [name]})
    (bench_root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = run_cell(bench_root, name, trace=True)
    assert result["metrics"]["frames_seen"]["value"] == result["attempted"]


def test_a_kept_fit_is_the_fit(tmp_path):
    """The fit left in the checkout is the fit, bit for bit, and a change
    of the fit's settings does not take it."""
    dev = torch.device("cpu")
    cfg = dict(TINY_CONFIG, fit=dict(TINY_CONFIG["fit"], steps=2))
    leaves = lambda p: [p["grid"], *p["density"], *p["color"]]  # noqa: E731
    fresh = field_lib.make_fields(cfg, ["lego"], SEED, dev)["lego"]
    made = field_lib.make_fields(cfg, ["lego"], SEED, dev, tmp_path)["lego"]
    kept = field_lib.make_fields(cfg, ["lego"], SEED, dev, tmp_path)["lego"]
    assert len(list(tmp_path.glob("lego-*.pt"))) == 1
    for x, y, z in zip(leaves(fresh), leaves(made), leaves(kept)):
        assert torch.equal(x, y) and torch.equal(x, z)
    other = dict(cfg, fit=dict(cfg["fit"], steps=1))
    assert (field_lib.fit_key(other, "lego", dev)
            != field_lib.fit_key(cfg, "lego", dev))


def test_fit_is_deterministic_and_the_seed_only_reorders_it():
    dev = torch.device("cpu")
    cfg = dict(TINY_CONFIG, fit=dict(TINY_CONFIG["fit"], steps=3))
    a = field_lib.make_fields(cfg, ["lego"], SEED, dev)["lego"]
    b = field_lib.make_fields(cfg, ["lego"], SEED, dev)["lego"]
    c = field_lib.make_fields(cfg, ["lego"], SEED + 1, dev)["lego"]
    leaves = lambda p: [p["grid"], *p["density"], *p["color"]]  # noqa: E731
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not any(torch.equal(x, y) for x, y in zip(leaves(a), leaves(c)))
    pts = torch.rand((4096, 3), generator=torch.Generator().manual_seed(0))
    dirs = torch.nn.functional.normalize(pts - 0.5, dim=-1)
    fa, fc = ngp.Field(a, cfg), ngp.Field(c, cfg)
    (sa, ga), (sc, gc) = fa.density(pts), fc.density(pts)
    torch.testing.assert_close(sa, sc, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(fa.color(ga, dirs), fc.color(gc, dirs),
                               rtol=1e-5, atol=1e-6)


def test_serve_poses_stay_beyond_the_probe_tiers_reach():
    """Any two poses of a serve scene fewer than ``fresh_within`` requests
    apart, at every position of the sequence: eye travel above the probe
    tier's 0.08 (framecache/probe.py), the widest tier's reach.  The R2
    step between poses k apart is the same at every k, so their distance
    depends only on where phi lies: every phi is tried.  The seed's
    shuffle moves a pose at most ``cycle`` - 1 places."""
    from repro_torch.framecache.probe import ProbeReuseConfig
    traffic = json.loads((ROOT / "bench" / "traffic"
                          / "serve-jump.json").read_text())
    (t_lo, t_hi), (p_lo, p_hi) = traffic["theta"], traffic["phi"]
    s_lo, s_hi = np.sin(p_lo), np.sin(p_hi)
    v = np.linspace(0.0, 1.0, 20001)
    nearest = np.inf
    for k in range(1, traffic["fresh_within"] + traffic["cycle"]):
        du, dv = (k * np.asarray(poses_lib.R2_STEPS)) % 1.0
        p1 = np.arcsin(s_lo + (s_hi - s_lo) * v)
        p2 = np.arcsin(s_lo + (s_hi - s_lo) * ((v + dv) % 1.0))
        cos = (np.cos(p1) * np.cos(p2) * np.cos((t_hi - t_lo) * du)
               + np.sin(p1) * np.sin(p2))
        angle = np.arccos(np.clip(cos, -1.0, 1.0)).min()
        nearest = min(nearest, 2 * traffic["radius"] * np.sin(angle / 2))
    assert nearest > ProbeReuseConfig().max_translation
    # the same poses as the sequence gives them, pairwise
    eyes = np.array([scenes.look_at_camera(8, 8, th, ph).origin
                     for th, ph in poses_lib.r2_poses(traffic, 7, 300)],
                    np.float64)
    gaps = np.linalg.norm(eyes[:, None] - eyes[None], axis=-1)
    near = np.abs(np.arange(300)[:, None] - np.arange(300)[None])
    gaps[(near == 0) | (near >= traffic["fresh_within"])] = np.inf
    assert gaps.min() >= nearest - 1e-4


def test_serve_refuses_tiers_that_remember_too_much(bench_root):
    from bench.drivers import serve
    traffic = dict(TINY_JUMP, fresh_within=40)
    with pytest.raises(RuntimeError, match="could hit"):
        serve.engine({}, TINY_CONFIG, traffic, torch.device("cpu"))


def test_seeds_order_the_same_poses():
    traffic = json.loads((ROOT / "bench" / "traffic" / "frames.json").read_text())
    a = poses_lib.r2_poses(traffic, 1, 40)
    b = poses_lib.r2_poses(traffic, 2 ** 31 + 17, 40)
    assert a != b and a == poses_lib.r2_poses(traffic, 1, 100)[:40]
    c = traffic["cycle"]
    assert sorted(a[:2 * c]) == sorted(b[:2 * c])


def test_march_reckoning_repeats_the_smokes():
    """The 800x800 frame of the smoke (chip_smoke.py ``march_reckoning``
    on its 157 blocks): 60,948,480 samples and 30,474,240 anchors within
    the budgets, a bound of 40.142 ms, set by the operations."""
    budgets = [12] * 2 + [24] + [48] * 3 + [96] * 11 + [192] * 140
    runs = [(1, 3), (2, 1), (1, 2), (3, 1), (1, 5), (2, 4), (3, 1), (6, 1),
            (2, 55), (3, 1), (2, 4), (3, 4), (2, 1), (3, 29), (4, 1), (3, 4),
            (4, 1), (3, 3), (4, 1), (3, 2), (4, 12), (6, 21)]
    chunks = [c for c, n in runs for _ in range(n)]
    assert len(chunks) == 157 and sum(chunks) == 467
    samples, anchors = _work.march_samples(budgets, chunks, 4096, 32, 2)
    assert (samples, anchors) == (60948480, 30474240)
    cfg = json.loads((ROOT / "bench" / "configs" / "ingp-asdr.json").read_text())
    flop, nbytes = _work.march_cost(cfg, 157, samples, anchors)
    assert flop / _work.PEAK_FP32 > nbytes / _work.PEAK_BYTES
    assert round(1e3 * _work.bound_s(flop, nbytes), 3) == 40.142
    bounds = {k: round(1e3 * _work.bound_s(*v), 3)
              for k, v in _work.probe_cost(cfg).items()}
    assert bounds == {"hash_encode": 0.225, "density_mlp": 0.451,
                      "color_mlp": 5.446}


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "ingp-asdr.frames", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout == ""


def imports_of(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "bench").rglob("*.py"))
    assert files
    for f in files:
        assert not imports_of(f) & set(harness.FORBIDDEN), f
    for f in sorted((ROOT / "bench" / "reference").glob("*.py")):
        assert "repro_torch" not in imports_of(f), f


def test_a_run_loads_no_jax_and_the_reference_no_port(bench_root):
    code = (
        "import sys, time, torch\n"
        f"sys.path[0:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}, "
        f"{str(ROOT / 'bench' / 'tests')!r}]\n"
        "import bench.reference.asdr, bench.reference.compare\n"
        "import bench.inputs.field\n"
        "assert not any(m.split('.')[0] == 'repro_torch' for m in sys.modules)\n"
        "from pathlib import Path\n"
        "from conftest import TINY_CONFIG, add_cell\n"
        "from bench import harness\n"
        "torch.set_num_threads(2)\n"
        f"root = Path({str(bench_root)!r})\n"
        "import json\n"
        f"wl = json.loads(Path({str(ROOT / 'bench' / 'workloads' / 'ingp-asdr.frames.json')!r}).read_text())\n"
        "add_cell(root, 't.frames', TINY_CONFIG, 'frames', dict(wl, check={'frames': 1}), like='ingp-asdr.frames')\n"
        "harness.execute(root, 't.frames', 5, 0.5, False, torch.device('cpu'), time.perf_counter())\n"
        "print(harness.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


# ---- the timed path broken underneath: each fault must fail the check


def half_the_blocks(real):
    """The march of the first half of a batch's blocks; the rest get the
    mean of those outputs."""
    def march(res, acfg, o_b, d_b, budgets, density_only=False):
        n = max(o_b.shape[0] // 2, 1)
        outs = real(res, acfg, o_b[:n], d_b[:n], budgets[:n],
                    density_only=density_only)
        full = []
        for t in outs:
            rest = t.float().mean(dim=0, keepdim=True).to(t.dtype)
            full.append(torch.cat([t, rest.expand(o_b.shape[0] - n,
                                                  *t.shape[1:])]))
        return tuple(full)
    return march


def altered_answer(real):
    """The real march with every colour it produces moved by 1e-3."""
    def march(res, acfg, o_b, d_b, budgets, density_only=False):
        rgb, *rest = real(res, acfg, o_b, d_b, budgets,
                          density_only=density_only)
        return (rgb + 1e-3, *rest)
    return march


def one_block_off(real):
    """The real march with the colours of each batch's first block moved
    by 1e-3: a fault in a few per cent of a frame's pixels."""
    def march(res, acfg, o_b, d_b, budgets, density_only=False):
        rgb, *rest = real(res, acfg, o_b, d_b, budgets,
                          density_only=density_only)
        return (torch.cat([rgb[:1] + 1e-3, rgb[1:]]), *rest)
    return march


@pytest.mark.parametrize("fault", [half_the_blocks, altered_answer,
                                   one_block_off])
@pytest.mark.parametrize("cell", [frames_cell, serve_cell])
def test_broken_timed_path_is_not_correct(bench_root, monkeypatch, fault,
                                          cell):
    from repro_torch.kernels import ops
    name = cell(bench_root)
    monkeypatch.setattr(ops, "fused_march_blocks",
                        fault(ops.fused_march_blocks))
    result, rows = run_cell(bench_root, name)
    assert not result["correct"], rows
