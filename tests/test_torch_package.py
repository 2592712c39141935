"""The port as a package: it imports nothing of JAX or of the reference
package, runs on the GPU unless asked for the CPU, builds no kernel when
imported, carries weights across from the reference's layouts and keeps
the reference's config numbers."""
import ast
import dataclasses
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ingp_asdr as j_bundles
from repro.core.model import NGPConfig as JNGPConfig, init_ngp
from repro_torch import params as tparams
from repro_torch.configs import ingp_asdr as t_bundles
from repro_torch.core import fields, pipeline, scene
from repro_torch.kernels import _build, ops

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_no_jax_and_no_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_default_device_is_the_gpu():
    cam = scene.look_at_camera(4, 4, theta=0.7, phi=0.5)
    if torch.cuda.is_available():
        assert scene.camera_rays(cam)[0].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scene.camera_rays(cam)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.render_asdr_image(
            fields.analytic_field_fns(scene.make_scene("mic")),
            pipeline.ASDRConfig(), cam)


def test_cpu_frame_runs_on_request():
    fns = fields.analytic_field_fns(scene.make_scene("mic"))
    acfg = pipeline.ASDRConfig(ns_full=48, probe_stride=4, block_size=32,
                               chunk=16, candidates=(12, 24))
    img, stats = pipeline.render_asdr_image(
        fns, acfg, scene.look_at_camera(8, 8, theta=0.7, phi=0.5), device="cpu")
    assert img.shape == (8, 8, 3) and img.device.type == "cpu"
    assert bool(torch.isfinite(img).all())
    assert stats["samples_processed"] > 0


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU every wrapper runs its plain version: no library is built
    or loaded and no launch is counted."""
    cfg = JNGPConfig.small()
    field = tparams.from_jax_params(
        jax.tree.map(np.asarray, init_ngp(jax.random.PRNGKey(0), cfg)), cfg,
        device="cpu")
    ops.reset_launch_counts()
    fns = ops.field_fns(field)
    acfg = pipeline.ASDRConfig(ns_full=32, probe_stride=4, block_size=32,
                               chunk=16, candidates=(8, 16),
                               march_backend="fused")
    pipeline.render_asdr_image(fns, acfg, scene.look_at_camera(8, 8, 0.7, 0.5),
                               device="cpu")
    enc = torch.zeros((5, cfg.net.encoding_dim))
    dirs = torch.nn.functional.normalize(torch.ones((5, 3)), dim=-1)
    ops.fused_field(enc, dirs, fns.fused, cfg.net)
    ops.volume_render(torch.ones((5, 8)), torch.ones((5, 4, 3)),
                      torch.ones((5, 8)), 2)
    assert ops.launch_counts() == {
        "hash_encode": 0, "density_mlp": 0, "color_mlp": 0, "fused_march": 0,
        "fused_field": 0, "volume_render": 0, "flash_attention": 0}
    assert not _build._libs


def test_cache_pickle_reads_without_the_reference_package(tmp_path):
    """The benchmark cache's pickle of (numpy params, NGPConfig) loads by
    attribute names; classes outside the config and numpy are refused."""
    cfg = JNGPConfig.small()
    host = jax.tree.map(np.asarray, init_ngp(jax.random.PRNGKey(1), cfg))
    path = tmp_path / "ngp.pkl"
    path.write_bytes(pickle.dumps((host, cfg)))
    field = tparams.load_cache_pickle(path, device="cpu")
    assert dataclasses.asdict(field.cfg) == dataclasses.asdict(cfg)
    np.testing.assert_array_equal(field.grid.numpy(), host["grid"])
    for got, want in zip(field.color_weights, host["mlps"]["color"]):
        np.testing.assert_array_equal(got.numpy(), want)
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(pickle.dumps((host, subprocess.Popen)))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tparams.load_cache_pickle(bad, device="cpu")


def test_random_params_layout():
    cfg = t_bundles.CONFIG.model
    p = tparams.random_params(dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, log2_table_size=8)), seed=0,
        table_scale=2.0)
    assert p["grid"].shape == (16, 256, 2) and np.abs(p["grid"]).max() <= 2.0
    assert [w.shape for w in p["mlps"]["density"]] == [(32, 64), (64, 16)]
    assert [w.shape for w in p["mlps"]["color"]] == [
        (31, 128), (128, 128), (128, 128), (128, 3)]


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_bundles_match_the_reference(name):
    j, t = getattr(j_bundles, name), getattr(t_bundles, name)
    assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
    assert dataclasses.asdict(t.asdr) == dataclasses.asdict(j.asdr)
    assert (t.name, t.image_hw, t.train_batch_rays) == (
        j.name, j.image_hw, j.train_batch_rays)


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_refuses_without_a_gpu(tmp_path, alone):
    """Without a CUDA device (and, alone in a directory, without the
    program) the smoke exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke would run in full")
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=script.parent, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
