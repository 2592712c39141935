"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ctypes: pointers and the stream go
in as ``c_void_p``, and each C function returns ``cudaGetLastError()``
after its launch.  The libraries land in ``kernels/build/`` (listed in
``.gitignore``) under a name keyed by the hash of the sources and flags,
so an edit rebuilds and an unchanged tree reuses what it built.
``build_all`` starts one ``nvcc`` per source, all at once.

The kernels held to their plain versions bit for bit are compiled with
``--fmad=false``: where a plain PyTorch version rounds each product and
each sum on its own, the kernel must too (the march's chunk counters
agree exactly only so), and nvcc must not contract ``a*b+c`` behind its
back.  A multiply-add that is meant to round once is written as the
``__fmaf_rn`` intrinsic, which the flag leaves alone: the color chains of
``fused_mlp.cu``, whose plain versions emulate ``fmaf``
(``fused_mlp.fma_plain``).  ``flash_attention`` is held by tolerance and
lets nvcc contract multiply-adds (``FMAD_SOURCES``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("hash_encode", "fused_mlp", "fused_march", "volume_render",
           "flash_attention")
FMAD_SOURCES = ("flash_attention",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
launch_lock = threading.Lock()   # guards every wrapper's ``launches``


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def nvcc_flags(name: str) -> tuple:
    """The flags ``csrc/<name>.cu`` is compiled with."""
    return NVCC_FLAGS + (() if name in FMAD_SOURCES else ("--fmad=false",))


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together.  Returns {name: {"seconds", "ptxas"}} for the
    sources built (ptxas lists registers, shared memory and spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        target = _lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *nvcc_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    report = {}
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, target)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under a lock: the serving engine
    launches kernels from its worker threads too, and a bare ``+= 1`` of
    two threads can lose one."""
    with launch_lock:
        wrapper.launches += 1


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require(what: str, t, dtype, ndim: int, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim`` dims
    on ``device`` — the only inputs the kernels take."""
    if (t.dtype != dtype or t.dim() != ndim or not t.is_contiguous()
            or t.device != device):
        raise ValueError(
            f"{what}: expected a contiguous {dtype} tensor of {ndim} dims on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
