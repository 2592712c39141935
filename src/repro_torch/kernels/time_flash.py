"""Time the flash attention kernel at gemma2-27b's prefill shapes.

    PYTHONPATH=<checkout>/src python3 -m repro_torch.kernels.time_flash

on a machine with one H100 and the CUDA toolkit.  The kernel is the one of
the ``repro_torch`` found on PYTHONPATH, so run under two checkouts in
turn (A, B, B, A) in one session on one card, the script compares their
kernels; of the package it uses only ``configs.get``, ``kernels._build``
and ``flash_attention`` / ``flash_attention_plain``.  It builds the flash
library alone (one nvcc) and prints ptxas's registers and spills for each
kernel.  Then, at the ``[lm]`` phase's two prefill waves (B x S of
SHAPES), on numpy-seeded bf16 q, k, v (B, S, H, Dh) / (B, S, KV, Dh) at
gemma2-27b's widths, for the local layer (window 4,096) and the global
layer, both with its softcap: the max abs error against the plain
version; a first reading, CUDA events around 3 launches after one
warm-up; then ROUNDS rounds of REPS launches, each round between CUDA
events.  Prints one JSON line a setting and the card's name and power
limit.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA

SEED = 8
CONFIG = "gemma2_27b"
SHAPES = ((4, 512), (1, 4608))
ROUNDS, REPS = 10, 20


def events_ms(fn, reps: int) -> float:
    """ms per call: CUDA events around ``reps`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("time_flash: no CUDA device")

    _build.SOURCES = ("flash_attention",)      # build this library alone
    for info in _build.build_all().values():
        for line in info["ptxas"].splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"[build] {line.strip()}", flush=True)
    cfg = configs.get(CONFIG)
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    c = cfg.attn_softcap
    rng = np.random.default_rng(SEED)
    for B, S in SHAPES:
        x = [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(
            "cuda", torch.bfloat16) for sh in ((B, S, H, Dh), (B, S, KV, Dh),
                                               (B, S, KV, Dh))]
        settings = ([("local", cfg.window)] if cfg.window else []) + [
            ("global", 0)]
        for kind, w in settings:
            def fn():
                return FA.flash_attention(*x, window=w, softcap=c)
            out = fn()
            err = float((out.float() - FA.flash_attention_plain(
                *x, w, c).float()).abs().max())
            first = events_ms(fn, 3)
            rounds = sorted(events_ms(fn, REPS) for _ in range(ROUNDS))
            print(json.dumps({
                "config": cfg.name, "B": B, "S": S, "H": H, "KV": KV,
                "Dh": Dh, "kind": kind, "window": w, "softcap": c,
                "max_abs_err": err, "first_ms": first,
                "median_ms": rounds[len(rounds) // 2], "min_ms": rounds[0],
                "max_ms": rounds[-1], "rounds": ROUNDS, "reps": REPS}),
                flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
