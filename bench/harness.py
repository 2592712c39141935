"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by name, so a later change adds a
configuration, a traffic mix, a cell or a metric as files and entries:

- ``BENCHMARK.json`` names the cell's configuration and traffic mix and
  lists the metrics (a metric with ``workloads`` belongs to those cells);
- ``bench/configs/<config>.json``: widths, ASDR settings, the fit;
- ``bench/traffic/<traffic>.json``: the driver and its parameters;
- ``bench/workloads/<cell>.json``: how many outputs the check compares
  and the limit of each number it compares;
- ``bench/drivers/<driver>.py``: ``setup(ctx)``, ``window(state,
  seconds)`` and ``check(state, obs)``;
- ``bench/metrics/<metric>.py``: ``read(obs)``, the metric's value or
  None where the run had nothing to read.

The run prints the numbers it compared beside their limits as its last
lines on standard error, then one JSON line on standard output.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from bench import devtrace
from bench.reference import compare

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path):
    """The module of one file, under a name of its own."""
    name = "bench_" + "_".join(path.with_suffix("").parts[-2:]).replace(
        ".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def find(cls, root: Path, name: str) -> "Cell":
        bench = load_json(root / "BENCHMARK.json")
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in bench["configs"] if c["name"] == entry["config"])

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]
        return cls(name, root, entry["chips"], load_json(root / conf["file"]),
                   load_json(root / "bench" / "traffic"
                             / f"{entry['traffic']}.json"),
                   load_json(root / "bench" / "workloads" / f"{name}.json"),
                   mine(bench["end_to_end"]), mine(bench["per_layer"]))


@dataclasses.dataclass
class Context:
    """What a driver's ``setup`` gets: the cell, the seed, the device,
    ``control``: None for the program, or the lower precision ("tf32")
    in which the reference stands in for it, and ``fits``: the
    checkout's directory of fitted fields (``inputs/field.py``)."""
    cell: Cell
    seed: int
    device: torch.device
    control: str | None = None
    fits: Path | None = None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "not measured"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "power_limit": limit or "not measured"}


def execute(root: Path, name: str, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float, control: str | None = None):
    """One run; returns (result dict, [(number, value, limit)])."""
    cell = Cell.find(root, name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = load_module(root / "bench" / "drivers"
                         / f"{cell.traffic['driver']}.py")
    t_cuda = time.perf_counter()
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    t_setup = time.perf_counter()
    state = driver.setup(Context(cell, seed, device, control,
                                 root / "bench" / "out" / "fits"))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    # set-up's parts: interpreter and imports, CUDA's start, the driver's
    parts = dict(start_s=t_cuda - t_start, cuda_s=t_setup - t_cuda,
                 **state.get("setup_parts", {}))
    with devtrace.traced(trace, device) as tr:
        obs = driver.window(state, seconds)
    obs["trace"] = tr
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    numbers = driver.check(state, obs)
    correct, rows = compare.verdict(numbers, cell.workload["limits"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = (setup_s if m["name"] == "setup_s" else load_module(
            root / "bench" / "metrics" / f"{m['name']}.py").read(obs))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(card(device), memory_peak_bytes=peak)
    result = {"correct": correct, "attempted": obs["attempted"],
              "failed": obs["failed"], "metrics": metrics, "device": dev}
    if trace and tr.get("busy_s") is not None:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["setup_parts"] = parts
    result["checked"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, root: Path, t_start: float) -> int:
    args = parse(argv)
    cell = Cell.find(root, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, rows = execute(root, args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: nothing it runs may import JAX or "
              f"the JAX package", file=sys.stderr)
        return 3
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in
                              result["setup_parts"].items()), file=sys.stderr)
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
