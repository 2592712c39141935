"""Time the hand-written kernels at other tile constants.

    PYTHONPATH=src python3 -m repro_torch.kernels.tile_variants [GROUP ...]

on a machine with one H100 and the CUDA toolkit; with no GROUP it runs all
of ``GROUPS``.  Each variant is the committed source with other values of
the ``constexpr int`` tile constants of one file: ``common.cuh`` for the
tile chains of ``fused_mlp.cu`` (rows per warp group, threads per group,
groups per CTA, rows of a thread's register tile), ``flash_attention.cu``
(``kBf16Warps``, ``kBf16MinCtas``: warps of 16 query rows per CTA of the
bf16 kernel and the CTAs an SM it is built for; ``kF32KB``,
``kF32MinCtas``: keys per tile and CTAs an SM of the fp32 one) and
``volume_render.cu`` (``kWarps``, ``kChunk``: warps per CTA and samples
per staged chunk) and ``hash_encode.cu`` (``kGroupFloats``: floats of a
work item's output, so levels a group; ``kLanesPerPoint``: lanes sharing
a work item; the wrapper's ``GROUP_FLOATS`` and ``LANES_PER_POINT``
mirror them while the variant runs; ``kStreamStores``,
``kEvictLast``: the stores' and the table loads' cache hints;
``kStagePoints``: points staged through shared memory).  Every variant
is built with the same nvcc flags into
``kernels/build/variants/``, one nvcc each, all at once, and runs its
group's cases: ``color_mlp`` and ``fused_field`` on the Phase-I rows of
the 800x800 ``CONFIG`` frame (25,600 probe rays x 192 samples, random
weights from seed 8 as in ``chip_smoke.py``); gemma2-27b's attention over
8,192 tokens (the global layer without softcap and the local layer, in
the group's dtype); the volume render at the decoupled frame's shape
(R 640,000 x S 192, A 96, group 2) on uniform random inputs from
``SEED``; the hash encode on the Phase-I rows and on the first decoupled
chunk's rows (65,536 rays x 192) of that frame.  Each prints its max abs error against the committed kernel (0
where the variant only regroups work; the fp32 attention's key tile
changes its online softmax's rounding) and is timed with CUDA events (the
mean of 10 launches after a warm-up) in two rounds, the second in reverse
order.  Prints one JSON line per variant, case and round, and the card's
name and power limit.
"""
from __future__ import annotations

import contextlib
import ctypes
import importlib
import json
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from . import _build

SEED, TABLE_SCALE, REPS = 8, 30.0, 10
CAMERA = dict(theta=0.9, phi=0.55)
ATTN_SEQ = 8192
# group -> (source, file of its tile constants, {variant: {constant: value}})
GROUPS = {
    "fused_mlp": ("fused_mlp", "common.cuh", {
        "32 rows x 2 groups of 4 warps, 4-row tiles (committed)": {},
        "one group of 64 rows":
            {"kTileRows": 64, "kGroupThreads": 256, "kTileGroups": 1},
        "four groups of 16 rows":
            {"kTileRows": 16, "kGroupThreads": 64, "kTileGroups": 4},
        "8-row tiles, one group of 4 warps":
            {"kTileRows": 64, "kTileGroups": 1, "kTR": 8},
        "8-row tiles, two groups of 2 warps":
            {"kGroupThreads": 64, "kTR": 8},
    }),
    "flash_attention bf16": ("flash_attention", "flash_attention.cu", {
        "8 warps, 128 query rows, 1 CTA an SM (committed)": {},
        "4 warps, 64 query rows, 2 CTAs an SM":
            {"kBf16Warps": 4, "kBf16MinCtas": 2},
        "4 warps, 64 query rows, 3 CTAs an SM":
            {"kBf16Warps": 4, "kBf16MinCtas": 3},
    }),
    "flash_attention fp32": ("flash_attention", "flash_attention.cu", {
        "32-key tiles, 2 CTAs an SM (committed)": {},
        "16-key tiles, 3 CTAs an SM": {"kF32KB": 16, "kF32MinCtas": 3},
        "64-key tiles, 1 CTA an SM": {"kF32KB": 64, "kF32MinCtas": 1},
    }),
    "hash_encode": ("hash_encode", "hash_encode.cu", {
        "2 lanes a point, 4 levels a group, streaming stores, points "
        "read directly (committed)": {},
        "1 lane a point": {"kLanesPerPoint": 1},
        "1 lane a point, points staged": {"kLanesPerPoint": 1,
                                          "kStagePoints": 1},
        "1 level a group": {"kGroupFloats": 2},
        "2 levels a group": {"kGroupFloats": 4},
        "8 levels a group": {"kGroupFloats": 16},
        "plain stores": {"kStreamStores": 0},
        "table loads L2::evict_last": {"kEvictLast": 1},
        "points staged through shared memory": {"kStagePoints": 1},
    }),
    "volume_render": ("volume_render", "volume_render.cu", {
        "2 warps, chunks of 16 samples (committed)": {},
        "1 warp, chunks of 16": {"kWarps": 1},
        "4 warps, chunks of 16": {"kWarps": 4},
        "8 warps, chunks of 16": {"kWarps": 8},
        "2 warps, chunks of 8": {"kChunk": 8},
        "2 warps, chunks of 32": {"kChunk": 32},
    }),
}


# Tile constants a wrapper mirrors in Python: constant -> (wrapper module
# under kernels/, attribute).
MIRRORS = {"kGroupFloats": ("hash_encode", "GROUP_FLOATS"),
           "kLanesPerPoint": ("hash_encode", "LANES_PER_POINT")}


@contextlib.contextmanager
def mirrored(consts: dict):
    """The wrappers' mirrors of ``consts`` set while a variant runs."""
    saved = []
    for name, value in consts.items():
        if name in MIRRORS:
            mod = importlib.import_module(f"{__package__}.{MIRRORS[name][0]}")
            saved.append((mod, MIRRORS[name][1],
                           getattr(mod, MIRRORS[name][1])))
            setattr(mod, MIRRORS[name][1], value)
    try:
        yield
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)


def with_constants(text: str, fname: str, consts: dict) -> str:
    """``text`` (of ``csrc/<fname>``) with the tile constants ``consts``."""
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise RuntimeError(f"{fname}: no single definition of {name}")
    return text


def build(groups) -> dict:
    """{(group, variant): (library, ptxas lines)}."""
    procs = {}
    for g in groups:
        src, fname, variants = GROUPS[g]
        for i, (name, consts) in enumerate(variants.items()):
            d = _build.BUILD_DIR / "variants" / f"{g.replace(' ', '-')}-{i}"
            d.mkdir(parents=True, exist_ok=True)
            for f in (f"{src}.cu", "common.cuh"):
                shutil.copy(_build.CSRC / f, d / f)
            (d / fname).write_text(with_constants(
                (_build.CSRC / fname).read_text(), fname, consts))
            cmd = [_build.nvcc(), *_build.nvcc_flags(src), "-o",
                   str(d / "lib.so"), str(d / f"{src}.cu")]
            procs[g, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), d)
    out = {}
    for key, (proc, d) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {key!r}:\n{log}")
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "stack frame" in ln]
        out[key] = (ctypes.CDLL(str(d / "lib.so")), lines)
    return out


def frame_samples(dev):
    """The field's fused-march resources (random weights from ``SEED``),
    the 800x800 ``CONFIG`` frame's rays and its Phase-I probe samples:
    (res, o, d, pts (N, 3), dirs (N, 3))."""
    from ..configs import ingp_asdr
    from ..core import scene
    from .. import params
    from . import ops

    bundle = ingp_asdr.CONFIG
    field = params.from_jax_params(
        params.random_params(bundle.model, SEED, TABLE_SCALE), bundle.model,
        device=dev)
    cam = scene.look_at_camera(*bundle.image_hw, **CAMERA)
    acfg = bundle.asdr
    o, d = scene.camera_rays(cam, device=dev)
    st = acfg.probe_stride
    jj, ii = torch.meshgrid(torch.arange(0, cam.height, st, device=dev),
                            torch.arange(0, cam.width, st, device=dev),
                            indexing="ij")
    probe = (jj * cam.width + ii).reshape(-1)
    pts, _, _ = scene.sample_points(o[probe], d[probe], acfg.ns_full)
    dirs = torch.repeat_interleave(d[probe], acfg.ns_full, dim=0)
    return (ops.FusedMarchResources(field), o, d,
            pts.reshape(-1, 3).contiguous(), dirs)


def phase_one_rows(dev):
    """enc, sh, cin and the two packed chains on the Phase-I rows."""
    from ..core import mlp as mlp_lib
    from . import fused_mlp as FM
    from . import hash_encode as HE

    res, _, _, pts, dirs = frame_samples(dev)
    enc = HE.hash_encode(pts, res.meta, res.tables)
    sh = mlp_lib.sh_encode(dirs, res.net.sh_degree).contiguous()
    dout = FM.density_mlp(enc, *res.density)
    cin = torch.cat([dout[:, 1:], sh], 1).contiguous()
    return enc, sh, cin, res.density, res.color


def cases(group: str, dev) -> list:
    """[(case name, call)] of ``group`` at the smoke's shapes."""
    if group == "fused_mlp":
        from . import fused_mlp as FM
        enc, sh, cin, (wd, dd), (wc, dc) = phase_one_rows(dev)
        return [("color_mlp", lambda: FM.color_mlp(cin, wc, dc)),
                ("fused_field",
                 lambda: FM.fused_field(enc, sh, wd, dd, wc, dc))]
    if group == "hash_encode":
        from ..configs import ingp_asdr
        from ..core import scene
        from . import hash_encode as HE
        res, o, d, pts, _ = frame_samples(dev)
        step = 1 << 16
        chunk, _, _ = scene.sample_points(o[:step], d[:step],
                                          ingp_asdr.CONFIG.asdr.ns_full)
        chunk = chunk.reshape(-1, 3).contiguous()
        return [(f"{x.shape[0]} {tag}",
                 lambda x=x: HE.hash_encode(x, res.meta, res.tables))
                for tag, x in (("Phase-I rows", pts),
                               ("decoupled chunk rows", chunk))]
    rng = np.random.default_rng(SEED)
    if group == "volume_render":
        from . import volume_render as VR
        R, S, A, g = 640_000, 192, 96, 2
        sig = torch.from_numpy(
            rng.uniform(0, 8, (R, S)).astype(np.float32)).to(dev)
        dl = torch.full((R, S), 0.02, device=dev)
        anch = torch.from_numpy(
            rng.uniform(size=(R, A, 3)).astype(np.float32)).to(dev)
        return [(f"R {R} S {S} A {A} group {g}",
                 lambda: VR.volume_render(sig, dl, anch, g))]
    from ..configs import gemma2_27b
    from . import flash_attention as FA
    cfg = gemma2_27b.CONFIG
    B, H, KV, Dh = 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = torch.bfloat16 if group.endswith("bf16") else torch.float32
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(dev).to(dt)
               for s in ((B, ATTN_SEQ, H, Dh), (B, ATTN_SEQ, KV, Dh),
                         (B, ATTN_SEQ, KV, Dh)))
    return [("global no softcap",
             lambda: FA.flash_attention(q, k, v, window=0, softcap=0.0)),
            ("local", lambda: FA.flash_attention(
                q, k, v, window=cfg.window, softcap=cfg.attn_softcap))]


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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("tile_variants: no CUDA device", file=sys.stderr)
        return 2
    groups = argv or list(GROUPS)
    unknown = set(groups) - set(GROUPS)
    if unknown:
        print(f"tile_variants: no group {sorted(unknown)}; the groups are "
              f"{list(GROUPS)}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = build(groups)
    calls = {g: cases(g, dev) for g in groups}
    want = {(g, c): fn() for g in groups for c, fn in calls[g]}
    keys = list(libs)
    for rnd, order in enumerate((keys, keys[::-1])):
        for g, name in order:
            src = GROUPS[g][0]
            lib, ptxas = libs[g, name]
            _build._libs[src] = lib
            for case, fn in calls[g]:
                with mirrored(GROUPS[g][2][name]):
                    ms = time_ms(fn)
                    err = (fn().float() - want[g, case].float()).abs().max()
                print(json.dumps({
                    "round": rnd, "group": g, "variant": name, "case": case,
                    "constants": GROUPS[g][2][name], "ms": ms,
                    "max_abs_err": float(err),
                    "ptxas": ptxas if rnd == 0 else None}), flush=True)
            _build._libs.pop(src, None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
