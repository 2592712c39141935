"""The readings that a cell's limits are set from, in one process: the
numbers the check compares, for the program on each of ``--seeds`` and
for the control (the reference in the program's place, in TF32) on each
of ``--control-seeds``, each run with a short window at the cell's own
load.  One JSON line a run on standard output; the benchmark's own runs
never run the control.

    python3 bench/readings.py --workload <cell> --seconds 3 \
        --seeds 11 12 ... --control-seeds 21 22 23 --control-seconds 8
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import harness  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seconds", type=float, default=8.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings are taken on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    runs = ([(s, None, args.seconds) for s in args.seeds]
            + [(s, "tf32", args.control_seconds) for s in args.control_seeds])
    for seed, control, seconds in runs:
        t0 = time.perf_counter()
        result, _ = harness.execute(ROOT, args.workload, seed, seconds,
                                    False, dev, t0, control=control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": control, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "seconds": time.perf_counter() - t0,
                          "setup_parts": result["setup_parts"],
                          "numbers": {k: v["value"] for k, v in
                                      result["checked"].items()}}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
