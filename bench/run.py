"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one run of
one cell on the card this process starts on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Kernel libraries build into the
port's own cache inside the checkout (``src/repro_torch/kernels/build``)
and the fitted fields into ``bench/out/fits``, so only a checkout's first
run compiles and fits.  See ``bench/harness.py``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the fit's matmuls must be deterministic: cuBLAS reads this when CUDA
# starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# the checkout's root and the port's sources, not this file's directory
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], ROOT, T_START))
