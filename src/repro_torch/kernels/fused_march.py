"""All of Phase II in one launch: CUDA kernel + plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/fused_march.py``
(``fused_march_call`` / ``_march_impl``, resident and streamed).  The CUDA
kernel (``csrc/fused_march.cu``, built by ``_build.py`` with nvcc for
sm_90a) is one persistent CTA per SM, launched cooperatively, that walks
the chunk steps of the longest budget: in each step its warp groups share
the units (32 rays of one block) of every block still running, and a
grid-wide barrier ends the step, after which each block's "any ray alive"
flag decides whether it runs the next chunk.  A unit walks its chunk's
samples in order as tiles of its 32 rays: hash encode, the density chain
on every sample and the color chain on every ``group``-th anchor (the
register-tiled chains of the MLP kernels), then the lerp and the
composite, one thread per ray, carrying log-transmittance across chunks.
Bound on the H100: operations (MLP FLOPs on the CUDA cores); the weights
sit in shared memory (``smem_bytes``), the tables in device memory behind
L2 (no counterpart of the TPU's VMEM residency or DMA ping-pong).

Output rows (N*B, 8): [acc, r, g, b, depth, block_chunks, ray_chunks, 0],
as the reference kernel's.

``fused_march`` launches the kernel for CUDA tensors and uses
``fused_march_plain`` only for tensors on the CPU.  The plain version has
the reference march's semantics (``core.pipeline._march_block``) and
repeats the kernel's arithmetic op by op — the encode, the density chain
with each product and sum rounded on its own (``dense_plain``), the color
chain with one rounding per multiply-add (``color_mlp_plain``), and the
compositing sums taken sample by sample — so on the card the two agree to
the bit and the chunk counters exactly.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .fused_mlp import (SMEM_LIMIT, chain_plain, check_smem, check_tile_dims,
                        color_mlp_plain, trunc_exp_plain, two_chain_floats)
from .hash_encode import MAX_FEAT, hash_encode_plain

OUT_W = 8
MAX_CHUNK = 64
GROUP_ROWS = 32              # rays of one tile, one warp group's
MAX_GROUPS = 3               # warp groups of a CTA where they fit
# the kernel's grid barrier and unit counters, before one flag per block
SYNC_WORDS = 4
# The plain version marches blocks side by side in groups of at most this
# many samples per chunk.
PLAIN_SAMPLES_PER_CALL = 1 << 22


def _march_group_plain(o, d, sh, budgets, meta, tables, wd, dims_d, wc,
                       dims_c, B, C, group, near, far, log_eps_t, early_term,
                       white_background, with_color, per_ray_exit):
    n = budgets.shape[0]
    dev = o.device
    o3, d3 = o.reshape(n, B, 3), d.reshape(n, B, 3)
    bud = budgets.to(torch.int32)
    delta_t = torch.full((n,), far - near, device=dev) / bud.float()
    n_chunks = (bud + C - 1) // C
    log_t = torch.zeros((n, B), device=dev)
    acc = torch.zeros((n, B), device=dev)
    dep = torch.zeros((n, B), device=dev)
    rgb = torch.zeros((n, B, 3), device=dev)
    ray_chunks = torch.zeros((n, B), device=dev)
    chunks = torch.zeros((n,), device=dev)
    G = dims_d[-1] - 1
    A = -(-C // group)
    jj = torch.arange(C, device=dev)
    anchors = torch.arange(0, C, group, device=dev)
    lerp_t = [float(np.float32(j % group) / np.float32(group)) for j in range(C)]
    left = [min(j // group, A - 1) for j in range(C)]
    right = [min(j // group + 1, A - 1) for j in range(C)]
    for ci in range(int(n_chunks.max()) if n else 0):
        run = ci < n_chunks
        if early_term:
            run = run & torch.any(log_t > log_eps_t, dim=1)
        act = torch.nonzero(run).flatten()
        if act.numel() == 0:
            break
        na = act.numel()
        lt = log_t[act]
        alive = lt > log_eps_t
        idx = ci * C + jj
        valid = idx[None, :] < bud[act, None]                    # (na, C)
        dt = delta_t[act]
        ts = near + (idx.float()[None, :] + 0.5) * dt[:, None]   # (na, C)
        pts = o3[act][:, :, None, :] + ts[:, None, :, None] * d3[act][:, :, None, :]
        flat = pts.reshape(-1, 3)
        h = chain_plain(hash_encode_plain(flat, meta, tables), wd, dims_d)
        inside = torch.all((flat >= 0.0) & (flat <= 1.0), dim=-1).reshape(na, B, C)
        sig = trunc_exp_plain(h[:, 0]).reshape(na, B, C)
        sig = torch.where(inside & valid[:, None, :], sig, 0.0)
        if per_ray_exit:
            sig = torch.where(alive[..., None], sig, 0.0)
        if with_color:
            geo = h[:, 1:].reshape(na, B, C, G)[:, :, anchors]
            S = sh.shape[-1]
            shp = sh.reshape(n, B, S)[act][:, :, None, :].expand(na, B, A, S)
            cin = torch.cat([geo, shp], dim=-1).reshape(-1, G + S)
            col = color_mlp_plain(cin, wc, dims_c).reshape(na, B, A, 3)
        incl = torch.zeros((na, B), device=dev)
        acc_c = torch.zeros((na, B), device=dev)
        dep_c = torch.zeros((na, B), device=dev)
        rc = torch.zeros((na, B, 3), device=dev)
        for j in range(C):
            alpha = 1.0 - torch.exp(-sig[..., j] * dt[:, None])
            ls = torch.log(torch.clamp(1.0 - alpha, 1e-10, 1.0))
            incl = incl + ls
            intra = incl - ls
            w = torch.exp(lt + intra) * alpha
            acc_c = acc_c + w
            dep_c = dep_c + w * ts[:, j:j + 1]
            if with_color:
                cl, cr = col[:, :, left[j]], col[:, :, right[j]]
                rc = rc + w[..., None] * (cl + (cr - cl) * lerp_t[j])
        acc[act] = acc[act] + acc_c
        if with_color:
            rgb[act] = rgb[act] + rc
        dep[act] = dep[act] + dep_c
        ray_chunks[act] = ray_chunks[act] + alive.float()
        log_t[act] = lt + incl
        chunks[act] = chunks[act] + 1.0
    depth = dep + (1.0 - acc) * far
    if with_color and white_background:
        rgb = rgb + (1.0 - acc)[..., None]
    return torch.cat([acc[..., None], rgb, depth[..., None],
                      chunks[:, None, None].expand(n, B, 1),
                      ray_chunks[..., None],
                      torch.zeros((n, B, 1), device=dev)], dim=-1).reshape(n * B, OUT_W)


def fused_march_plain(o, d, sh, budgets, meta, tables, wd, dims_d, wc, dims_c,
                      *, block_size, chunk, group, near, far, log_eps_t,
                      early_term=True, white_background=True,
                      with_color=True, per_ray_exit=False):
    """The kernel's function in plain torch, over groups of blocks."""
    N, B = budgets.shape[0], block_size
    step = max(1, PLAIN_SAMPLES_PER_CALL // (B * chunk))
    parts = []
    for s in range(0, N, step):
        e = min(N, s + step)
        parts.append(_march_group_plain(
            o[s * B:e * B], d[s * B:e * B],
            sh[s * B:e * B] if with_color else None, budgets[s:e], meta,
            tables, wd, dims_d, wc, dims_c, B, chunk, group, near, far,
            log_eps_t, early_term, white_background, with_color,
            per_ray_exit))
    return torch.cat(parts) if parts else torch.zeros((0, OUT_W), device=o.device)


def _fn(name):
    return getattr(_build.library("fused_march"), name)


def _plan_bytes(dims_d, dims_c, S, chunk, n_levels, groups):
    rows = GROUP_ROWS * groups
    return (4 * (two_chain_floats(dims_d, dims_c, rows)
                 + rows * (chunk + 6 + S + 2)) + 12 * n_levels)


def warp_groups(dims_d, dims_c, S: int, chunk: int, n_levels: int) -> int:
    """Warp groups a CTA of the kernel runs: ``MAX_GROUPS`` where their
    shared memory fits ``SMEM_LIMIT``, else two."""
    return (MAX_GROUPS if _plan_bytes(dims_d, dims_c, S, chunk, n_levels,
                                      MAX_GROUPS) <= SMEM_LIMIT else 2)


def smem_bytes(dims_d, dims_c, S: int, chunk: int, n_levels: int) -> int:
    """Dynamic shared memory of the march kernel: the fused field's plan
    for both chains' weights and each warp group's activations, then per
    tile row the march's own buffers (``chunk`` sigmas, two anchor colors,
    ``S`` SH features, two flags) and the (L, 3) grid meta."""
    return _plan_bytes(dims_d, dims_c, S, chunk, n_levels,
                       warp_groups(dims_d, dims_c, S, chunk, n_levels))


def _ints(N, B, chunk, group, L, F, S, early_term, white_background,
          with_color, per_ray_exit, dims_d, dims_c):
    return (ctypes.c_int * 13)(
        N, B, chunk, group, L, F, S, int(early_term), int(white_background),
        int(with_color), int(per_ray_exit), len(dims_d) - 1, len(dims_c) - 1)


def launch_smem(dims_d, dims_c, S: int, chunk: int, n_levels: int) -> int:
    """Bytes of shared memory the kernel's launcher asks for (the compiled
    library's own reckoning; builds it)."""
    fn = _fn("fused_march_smem")
    IP = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [IP, IP, IP]
    fn.restype = ctypes.c_longlong
    ints = _ints(1, 32, chunk, 1, n_levels, 1, S, 1, 1, 1, 0, dims_d, dims_c)
    return int(fn(ints, (ctypes.c_int * len(dims_d))(*dims_d),
                  (ctypes.c_int * len(dims_c))(*dims_c)))


def fused_march(o, d, sh, budgets, meta, tables, wd, dims_d, wc, dims_c, *,
                block_size, chunk, group, near, far, log_eps_t,
                early_term=True, white_background=True, with_color=True,
                per_ray_exit=False):
    """o/d (N*B, 3), sh (N*B, S) (None without color), budgets (N,) i32,
    meta (L, 3) i32, tables (L, T, F), wd/wc flat chains with widths
    dims_d/dims_c -> packed (N*B, 8).  CUDA tensors launch the kernel."""
    kw = dict(block_size=block_size, chunk=chunk, group=group, near=near,
              far=far, log_eps_t=log_eps_t, early_term=early_term,
              white_background=white_background, with_color=with_color,
              per_ray_exit=per_ray_exit)
    if o.device.type == "cpu":
        return fused_march_plain(o, d, sh, budgets, meta, tables, wd, dims_d,
                                 wc, dims_c, **kw)
    dev = o.device
    N, B = budgets.shape[0], block_size
    for name, t, dt, nd in (("o", o, torch.float32, 2), ("d", d, torch.float32, 2),
                            ("budgets", budgets, torch.int32, 1),
                            ("meta", meta, torch.int32, 2),
                            ("tables", tables, torch.float32, 3),
                            ("wd", wd, torch.float32, 1),
                            ("wc", wc, torch.float32, 1)):
        _build.require(f"fused_march {name}", t, dt, nd, dev)
    L, T, F = tables.shape
    S = 0
    if with_color:
        _build.require("fused_march sh", sh, torch.float32, 2, dev)
        S = sh.shape[1]
        if sh.shape[0] != N * B:
            raise ValueError("fused_march: one SH row per ray")
    check_tile_dims(dims_d)
    check_tile_dims(dims_c)
    if (tuple(o.shape) != (N * B, 3) or tuple(d.shape) != (N * B, 3)
            or not 1 <= chunk <= MAX_CHUNK or group < 1 or B < 1
            or F > MAX_FEAT or dims_d[0] != L * F
            or (with_color and (dims_c[0] != dims_d[-1] - 1 + S
                                or dims_c[-1] != 3))):
        raise ValueError(
            f"fused_march: rays {tuple(o.shape)} for {N} blocks of {B}, "
            f"chunk {chunk} (1 .. {MAX_CHUNK}), group {group}, tables "
            f"{tuple(tables.shape)}, widths {dims_d} / {dims_c} with S={S}")
    check_smem("fused_march", smem_bytes(dims_d, dims_c, S, chunk, L),
               (dims_d, dims_c, S, chunk))
    out = torch.zeros((N * B, OUT_W), dtype=torch.float32, device=dev)
    sync = torch.zeros((SYNC_WORDS + N,), dtype=torch.int32, device=dev)
    ints = _ints(N, B, chunk, group, L, F, S, early_term, white_background,
                 with_color, per_ray_exit, dims_d, dims_c)
    floats = (ctypes.c_float * 4)(near, far - near, far, log_eps_t)
    fn = _fn("fused_march_launch")
    if fn.argtypes is None:
        P, IP = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [P, P, P, P, P, P, ctypes.c_longlong, P, P, IP, IP, IP,
                       ctypes.POINTER(ctypes.c_float), P, P, P]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(o.data_ptr(), d.data_ptr(),
                 sh.data_ptr() if with_color else None,
                 budgets.data_ptr(), meta.data_ptr(), tables.data_ptr(), T,
                 wd.data_ptr(), wc.data_ptr(), ints,
                 (ctypes.c_int * len(dims_d))(*dims_d),
                 (ctypes.c_int * len(dims_c))(*dims_c), floats,
                 out.data_ptr(), sync.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "fused_march")
    fused_march.launches += 1
    return out


fused_march.launches = 0
