"""Time the tile kernels of ``csrc/fused_mlp.cu`` at other tile shapes.

    PYTHONPATH=src python3 -m repro_torch.kernels.tile_variants

on a machine with one H100 and the CUDA toolkit.  Each variant is the
committed source with other values of the tile constants in
``csrc/common.cuh`` (rows per warp group, threads per group, groups per
CTA, rows of a thread's register tile) or another unroll depth of the
tile loop, built with the same nvcc flags into ``kernels/build/variants/``.
Every variant runs ``color_mlp`` and ``fused_field`` on the Phase-I rows
of the 800x800 ``CONFIG`` frame (25,600 probe rays x 192 samples, random
weights from seed 8 as in ``chip_smoke.py``), is held bit for bit against
the committed kernels, and is timed with CUDA events (mean of 10 launches
after a warm-up) in two rounds, the second in reverse order.  Prints one
JSON line per variant and round, and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import torch

from . import _build
from . import fused_mlp as FM

SEED, TABLE_SCALE, REPS = 8, 30.0, 10
CAMERA = dict(theta=0.9, phi=0.55)
UNROLL = "#pragma unroll 8\n  for (int k = 0; k < K; ++k) {\n    float a[kTR]"
# name -> (kTileRows, kGroupThreads, kTileGroups, kTR, tile-loop unroll)
VARIANTS = {
    "committed": (32, 128, 2, 4, 8),
    "one group of 64 rows": (64, 256, 1, 4, 8),
    "four groups of 16 rows": (16, 64, 4, 4, 8),
    "8-row tiles, one group of 4 warps": (64, 128, 1, 8, 8),
    "8-row tiles, two groups of 2 warps": (32, 64, 2, 8, 8),
    "tile loop unrolled 4": (32, 128, 2, 4, 4),
}


def variant_header(rows, threads, groups, tr, unroll) -> str:
    src = (_build.CSRC / "common.cuh").read_text()
    for name, value in (("kTileRows", rows), ("kGroupThreads", threads),
                        ("kTileGroups", groups), ("kTR", tr)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"common.cuh: no single definition of {name}")
    if UNROLL not in src:
        raise RuntimeError("common.cuh: tile loop not found")
    return src.replace(UNROLL, UNROLL.replace("unroll 8", f"unroll {unroll}"))


def build(variants) -> dict:
    """{name: (library, ptxas lines of the two tile kernels)}."""
    procs = {}
    for i, (name, consts) in enumerate(variants.items()):
        d = _build.BUILD_DIR / "variants" / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "common.cuh").write_text(variant_header(*consts))
        (d / "fused_mlp.cu").write_text((_build.CSRC / "fused_mlp.cu").read_text())
        cmd = [_build.nvcc(), *_build.nvcc_flags("fused_mlp"), "-o",
               str(d / "lib.so"), str(d / "fused_mlp.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), d)
    out = {}
    for name, (proc, d) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "stack frame" in ln]
        out[name] = (ctypes.CDLL(str(d / "lib.so")), lines)
    return out


def phase_one_rows(dev):
    """enc, sh, cin and the two packed chains on the Phase-I rows."""
    from ..configs import ingp_asdr
    from ..core import mlp as mlp_lib
    from ..core import scene
    from .. import params
    from . import ops

    bundle = ingp_asdr.CONFIG
    field = params.from_jax_params(
        params.random_params(bundle.model, SEED, TABLE_SCALE), bundle.model,
        device=dev)
    cam = scene.look_at_camera(*bundle.image_hw, **CAMERA)
    acfg, res = bundle.asdr, ops.FusedMarchResources(field)
    o, d = scene.camera_rays(cam, device=dev)
    st = acfg.probe_stride
    jj, ii = torch.meshgrid(torch.arange(0, cam.height, st, device=dev),
                            torch.arange(0, cam.width, st, device=dev),
                            indexing="ij")
    probe = (jj * cam.width + ii).reshape(-1)
    pts, _, _ = scene.sample_points(o[probe], d[probe], acfg.ns_full)
    dirs = torch.repeat_interleave(d[probe], acfg.ns_full, dim=0)
    enc = ops.hash_encode(pts.reshape(-1, 3), res.tables, field.cfg.grid)
    sh = mlp_lib.sh_encode(dirs, field.cfg.net.sh_degree).contiguous()
    dout = FM.density_mlp(enc, *res.density)
    cin = torch.cat([dout[:, 1:], sh], 1).contiguous()
    return enc, sh, cin, res.density, res.color


def time_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    if not torch.cuda.is_available():
        print("tile_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = build(VARIANTS)
    enc, sh, cin, (wd, dd), (wc, dc) = phase_one_rows(dev)
    want_c = FM.color_mlp(cin, wc, dc)
    want_f = FM.fused_field(enc, sh, wd, dd, wc, dc)
    names = list(VARIANTS)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            lib, ptxas = libs[name]
            _build._libs["fused_mlp"] = lib
            c_ms = time_ms(lambda: FM.color_mlp(cin, wc, dc))
            f_ms = time_ms(lambda: FM.fused_field(enc, sh, wd, dd, wc, dc))
            exact = (torch.equal(FM.color_mlp(cin, wc, dc), want_c) and
                     torch.equal(FM.fused_field(enc, sh, wd, dd, wc, dc), want_f))
            rows, threads, groups, tr, unroll = VARIANTS[name]
            print(json.dumps({
                "round": rnd, "variant": name, "rows_per_group": rows,
                "group_threads": threads, "groups": groups, "tile_rows": tr,
                "unroll": unroll, "color_mlp_ms": c_ms, "fused_field_ms": f_ms,
                "bit_equal": exact, "ptxas": ptxas if rnd == 0 else None}),
                flush=True)
    _build._libs.pop("fused_mlp", None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
