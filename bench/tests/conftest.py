"""CPU tests of the benchmark: a cell at a tiny size runs through the
whole harness here, with the port's kernels on their plain versions."""
import json
import os
import shutil
import sys
from pathlib import Path

import pytest

# the fit's matmuls are deterministic only with this set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# The tiny configuration: the port's ``SMOKE`` widths and ASDR settings
# at 48 x 48, fitted for a few steps.
TINY_CONFIG = {
    "name": "tiny", "source": "test", "reduced": [], "assumed": [],
    "precision": "float32, TF32 off",
    "grid": {"n_levels": 8, "log2_table_size": 14, "feature_dim": 2,
             "base_resolution": 16, "max_resolution": 256},
    "mlp": {"density_hidden": 64, "density_layers": 1, "geo_feature_dim": 15,
            "sh_degree": 4, "color_hidden": 64, "color_layers": 2},
    "asdr": {"ns_full": 64, "probe_stride": 4, "delta": 0.00048828125,
             "candidates": [8, 16, 32], "group": 2, "block_size": 64,
             "chunk": 16, "early_termination": True,
             "white_background": True, "march_backend": "fused"},
    "image_hw": [48, 48],
    "fit": {"steps": 20, "points": 4096, "lr": 0.01, "density_eps": 0.001,
            "solid_sigma": 1.0, "color_weight": 1.0},
}


def add_cell(root: Path, cell: str, config: dict, traffic: str,
             workload: dict, like: str, traffic_params: dict = None):
    """Add a configuration, a cell and (optionally) a traffic mix to the
    benchmark at ``root`` as new files and BENCHMARK.json entries; the
    cell reports the metrics that cell ``like`` reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfile = root / "bench" / "configs" / f"{config['name']}.json"
    cfile.write_text(json.dumps(config))
    if not any(c["name"] == config["name"] for c in bench["configs"]):
        bench["configs"].append({"name": config["name"], "source": "test",
                                 "file": str(cfile.relative_to(root)),
                                 "reduced": [], "why": "test"})
    if traffic_params is not None:
        (root / "bench" / "traffic" / f"{traffic}.json").write_text(
            json.dumps(traffic_params))
    (root / "bench" / "workloads" / f"{cell}.json").write_text(
        json.dumps(dict(workload, config=config["name"], traffic=traffic)))
    bench["workloads"].append({"name": cell, "config": config["name"],
                               "traffic": traffic, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def bench_root(tmp_path):
    """A copy of BENCHMARK.json and bench/ to add files to."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__",
                                                  "tests"))
    return tmp_path
