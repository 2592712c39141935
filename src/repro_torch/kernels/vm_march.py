"""Phase II of a TensoRF VM field in one launch: CUDA kernel + plain
PyTorch version.

It replaces no TPU kernel: the JAX package has no VM field.  It is
``fused_march``'s counterpart for ``core/tensorf.py`` with the same
contract: rows [acc, r, g, b, depth, block_chunks, ray_chunks, 0], the
block-level early exit under ``early_term``, ``per_ray_exit`` honoured,
density on every sample and the colour on every ``group``-th anchor,
lerped between anchors (§4.3).  The kernel (``csrc/vm_march.cu``, built
by ``_build.py`` for sm_90a with ``--fmad=false``) keeps the fused
march's schedule: one persistent CTA per SM, launched cooperatively,
walks the chunk steps of the longest budget; its warp groups take units
of 32 rays of one block from a counter, and a grid barrier ends a step.

Per sample tile (32 rays at one sample index) four threads share a ray:
each reads a quarter of the density components of the three planes and
lines (channels innermost, one float4 a tap) and the four partial sums
meet by two warp shuffles.  On an anchor tile that some sample of the
chunk needs (the last valid sample's right anchor included, past the
budget), the same four threads read the appearance planes and lines
into the tile's k-major activations, then the group runs the basis with
the PE of its outputs, and the biased 150 -> 128 -> 128 -> 3 chain with
one rounding per multiply-add (``__fmaf_rn``), as ``dense_plain_fma``
emulates; anchors no sample needs are not evaluated and read as zero.
The kernel counts, per block, the ray-anchors it evaluated, and adds
them to a running total per device (``anchor_count``).

Bound on the H100: the appearance chain's operations (~82 kFLOP an
anchor) and the gathers: the density tensor (17.3 MB) stays in L2, the
appearance tensor (51.8 MB) does not.  Density needs no MLP.

The plain version repeats the kernel's arithmetic op by op: each tap's
bilinear sum in the order nw, ne, sw, se with the weights as
``grid_sample`` forms them, the density components summed per thread in
the kernel's order and the four partials as (p0 + p1) + (p2 + p3), the
chains through ``dense_plain_fma`` and a separate bias add, the
compositing sums sample by sample; so on the card the two agree to the
bit and the chunk counters exactly.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.tensorf import MAT_MODE, VEC_MODE, positional_encoding
from . import _build
from .fused_mlp import SMEM_LIMIT, dense_plain_fma, sigmoid_plain

OUT_W = 8
MAX_CHUNK = 64
GROUP_ROWS = 32              # rays of one tile, one warp group's
LANES = 4                    # threads of one ray in the gathers
GROUPS = 2                   # warp groups a CTA (kGroups in the kernel)
SYNC_WORDS = 4
PLAIN_SAMPLES_PER_CALL = 1 << 21


class VMTables(NamedTuple):
    """A VM field as the kernel reads it: each group of three planes
    (H, W, C) and lines (H, C) flat, channels innermost, one after
    another; the basis (K, A) and the chain's (in, out) weights and biases
    flat at ``offsets`` (each a multiple of 4 floats)."""
    res: Tuple[int, int, int]
    cd: int
    ca: int
    dplane: torch.Tensor
    dline: torch.Tensor
    aplane: torch.Tensor
    aline: torch.Tensor
    weights: torch.Tensor
    offsets: Tuple[int, ...]      # w1, b1, w2, b2, w3, b3, total
    app_dim: int
    hidden: int
    mlp_in: int
    fea_pe: int
    view_pe: int
    sigma_scale: float
    density_shift: float


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def pack_tables(cfg, params: dict) -> VMTables:
    """The kernel's layout of a ``core.tensorf`` params dict (TensoRF's
    (1, C, H, W) planes, (1, C, H, 1) lines, (out, in) weights)."""
    if len(set(cfg.density_components)) != 1 or len(
            set(cfg.app_components)) != 1:
        raise ValueError("vm_march: one component count a group: "
                         f"{cfg.density_components} / {cfg.app_components}")

    def planes(ts):
        return torch.cat([t[0].permute(1, 2, 0).reshape(-1) for t in ts])

    def lines(ts):
        return torch.cat([t[0, :, :, 0].t().reshape(-1) for t in ts])

    mlp = params["mlp"]
    pieces = [params["basis"].t(), mlp[0].t(), mlp[1], mlp[2].t(), mlp[3],
              mlp[4].t(), mlp[5]]
    flat, offsets, at = [], [], 0
    for p in pieces:
        p = p.float().contiguous().reshape(-1)
        offsets.append(at)
        flat += [p, torch.zeros((_pad4(p.numel()) - p.numel(),),
                                device=p.device)]
        at += _pad4(p.numel())
    return VMTables(
        tuple(cfg.resolution), cfg.density_components[0],
        cfg.app_components[0],
        planes(params["density_plane"]).contiguous(),
        lines(params["density_line"]).contiguous(),
        planes(params["app_plane"]).contiguous(),
        lines(params["app_line"]).contiguous(),
        torch.cat(flat).contiguous(), tuple(offsets[1:]) + (at,),
        cfg.app_dim, cfg.hidden, cfg.mlp_in, cfg.fea_pe, cfg.view_pe,
        float(np.float32(cfg.sigma_scale)),
        float(np.float32(cfg.density_shift)))


def chain_weights(tb: VMTables):
    """(basis (K, A), w1, b1, w2, b2, w3, b3) as views of ``weights``."""
    o = (0,) + tb.offsets
    K = 3 * tb.ca
    shapes = [(K, tb.app_dim), (tb.mlp_in, tb.hidden), (tb.hidden,),
              (tb.hidden, tb.hidden), (tb.hidden,), (tb.hidden, 3), (3,)]
    return [tb.weights[o[i]:o[i] + int(np.prod(s))].reshape(s)
            for i, s in enumerate(shapes)]


def view_features(d, view_pe: int):
    """Each ray's direction rows of the chain's input: [d, PE(d)]
    (R, 3 + 6 view_pe)."""
    return torch.cat([d, positional_encoding(d, view_pe)], dim=-1)


# ---- the plain version ----------------------------------------------------

def _lin(xn, size: int):
    """A coordinate's texel and weights as ``grid_sample`` forms them
    (``align_corners=True``): (i0, w0, w1, ok0, ok1)."""
    u = ((xn + 1.0) / 2.0) * float(size - 1)
    fl = torch.floor(u)
    i0 = fl.to(torch.int64)
    return (i0, (fl + 1.0) - u, u - fl, (i0 >= 0) & (i0 < size),
            (i0 >= -1) & (i0 + 1 < size))


def _tap(tab, off: int, texel, ok, C: int):
    idx = off + texel.clamp(min=0) * C
    cols = idx[:, None] + torch.arange(C, device=tab.device)
    v = tab[cols.clamp(max=tab.numel() - 1)]
    return torch.where(ok[:, None], v, 0.0)


def _plane_line(plane, line, tb: VMTables, xn, i: int, C: int):
    """Pair ``i``'s plane and line values (n, C) at normalized points."""
    res = tb.res
    a, b = MAT_MODE[i]
    v = VEC_MODE[i]
    poff = sum(res[MAT_MODE[j][0]] * res[MAT_MODE[j][1]] for j in range(i)) * C
    loff = sum(res[VEC_MODE[j]] for j in range(i)) * C
    W, H = res[a], res[b]
    x0, wx0, wx1, okx0, okx1 = _lin(xn[:, a], W)
    y0, wy0, wy1, oky0, oky1 = _lin(xn[:, b], H)
    z0, wz0, wz1, okz0, okz1 = _lin(xn[:, v], res[v])
    wnw, wne = (wx0 * wy0)[:, None], (wx1 * wy0)[:, None]
    wsw, wse = (wx0 * wy1)[:, None], (wx1 * wy1)[:, None]
    pv = _tap(plane, poff, y0 * W + x0, okx0 & oky0, C) * wnw
    pv = pv + _tap(plane, poff, y0 * W + x0 + 1, okx1 & oky0, C) * wne
    pv = pv + _tap(plane, poff, (y0 + 1) * W + x0, okx0 & oky1, C) * wsw
    pv = pv + _tap(plane, poff, (y0 + 1) * W + x0 + 1, okx1 & oky1, C) * wse
    lv = _tap(line, loff, z0, okz0, C) * wz0[:, None]
    lv = lv + _tap(line, loff, z0 + 1, okz1, C) * wz1[:, None]
    return pv, lv


def density_plain(points, tb: VMTables):
    """sigma (n,) at points (n, 3), zero outside the unit cube: each of
    the ray's four threads sums its components (channel c on thread
    (c // 4) % 4) pair by pair, then (p0 + p1) + (p2 + p3)."""
    xn = points * 2.0 - 1.0
    prods = [torch.mul(*_plane_line(tb.dplane, tb.dline, tb, xn, i, tb.cd))
             for i in range(3)]
    parts = []
    for q in range(LANES):
        acc = torch.zeros(points.shape[0], device=points.device)
        for p in prods:
            for c in range(tb.cd):
                if (c // 4) % LANES == q:
                    acc = acc + p[:, c]
        parts.append(acc)
    x = (parts[0] + parts[1]) + (parts[2] + parts[3]) + tb.density_shift
    sigma = tb.sigma_scale * torch.where(x > 20.0, x,
                                         torch.log1p(torch.exp(x)))
    inside = torch.all((points >= 0.0) & (points <= 1.0), dim=-1)
    return torch.where(inside, sigma, 0.0)


def appearance_plain(points, view, tb: VMTables):
    """rgb (n, 3) at points (n, 3) with their rays' ``view_features``."""
    xn = points * 2.0 - 1.0
    prods = torch.cat([torch.mul(*_plane_line(tb.aplane, tb.aline, tb, xn,
                                              i, tb.ca)) for i in range(3)],
                      dim=1)
    wb, w1, b1, w2, b2, w3, b3 = chain_weights(tb)
    feat = dense_plain_fma(prods, wb)
    x = torch.cat([feat, view[:, :3], positional_encoding(feat, tb.fea_pe),
                   view[:, 3:]], dim=1)
    x = torch.relu(dense_plain_fma(x, w1) + b1)
    x = torch.relu(dense_plain_fma(x, w2) + b2)
    return sigmoid_plain(dense_plain_fma(x, w3) + b3)


def needed_anchors(valid, group: int, chunk: int):
    """(anchors (..., A) bool) a chunk evaluates when ``valid`` of its
    samples lie within the budget: every anchor at or before the last
    valid sample, and the next one where that sample lerps towards it."""
    A = -(-chunk // group)
    m = torch.arange(A, device=valid.device)
    last = (valid - 1) // group
    extra = ((valid - 1) % group != 0) & (last + 1 < A)
    return (m <= last[..., None]) | (extra[..., None] & (m == last[..., None] + 1))


def _march_group_plain(o, d, view, budgets, tb, B, C, group, near, far,
                       log_eps_t, early_term, white_background, with_color,
                       per_ray_exit):
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
    anchors = torch.zeros((n,), dtype=torch.int64, device=dev)
    A = -(-C // group)
    jj = torch.arange(C, device=dev)
    lerp_t = [float(np.float32(j % group) / np.float32(group)) for j in range(C)]
    left = [min(j // group, A - 1) for j in range(C)]
    right = [min(j // group + 1, A - 1) for j in range(C)]
    units = -(-B // GROUP_ROWS)
    unit_rays = torch.tensor([min(GROUP_ROWS, B - GROUP_ROWS * u)
                              for u in range(units)], device=dev)
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
        sig = density_plain(pts.reshape(-1, 3), tb).reshape(na, B, C)
        sig = torch.where(valid[:, None, :], sig, 0.0)
        if per_ray_exit:
            sig = torch.where(alive[..., None], sig, 0.0)
        if with_color:
            need = needed_anchors(valid.sum(1), group, C)        # (na, A)
            col = torch.zeros((na, B, A, 3), device=dev)
            blk, anc = torch.nonzero(need, as_tuple=True)
            if blk.numel():
                pa = pts[:, :, ::group][blk, :, anc].reshape(-1, 3)
                va = view.reshape(n, B, -1)[act][blk].reshape(-1, view.shape[1])
                col[blk, :, anc] = appearance_plain(pa, va, tb).reshape(
                    blk.numel(), B, 3)
            if per_ray_exit:
                live = torch.nn.functional.pad(
                    alive, (0, units * GROUP_ROWS - B)).reshape(
                        na, units, GROUP_ROWS).any(-1)
                rays = (live * unit_rays).sum(1)
            else:
                rays = torch.full((na,), B, device=dev)
            anchors[act] += need.sum(1) * rays
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
    out = torch.cat([acc[..., None], rgb, depth[..., None],
                     chunks[:, None, None].expand(n, B, 1),
                     ray_chunks[..., None],
                     torch.zeros((n, B, 1), device=dev)], dim=-1)
    return out.reshape(n * B, OUT_W), anchors.to(torch.int32)


def vm_march_plain(o, d, view, budgets, tb: VMTables, *, block_size, chunk,
                   group, near, far, log_eps_t, early_term=True,
                   white_background=True, with_color=True,
                   per_ray_exit=False):
    """The kernel's function in plain torch, over groups of blocks:
    (rows (N*B, 8), ray-anchors evaluated per block (N,) int32)."""
    N, B = budgets.shape[0], block_size
    step = max(1, PLAIN_SAMPLES_PER_CALL // (B * chunk))
    outs, anchors = [], []
    for s in range(0, N, step):
        e = min(N, s + step)
        out, anc = _march_group_plain(
            o[s * B:e * B], d[s * B:e * B],
            view[s * B:e * B] if with_color else None, budgets[s:e], tb, B,
            chunk, group, near, far, log_eps_t, early_term, white_background,
            with_color, per_ray_exit)
        outs.append(out)
        anchors.append(anc)
    if not outs:
        return (torch.zeros((0, OUT_W), device=o.device),
                torch.zeros((0,), dtype=torch.int32, device=o.device))
    return torch.cat(outs), torch.cat(anchors)


# ---- the kernel ------------------------------------------------------------

def plan(tb: VMTables, chunk: int):
    """(floats of a group's activations, floats of its other buffers,
    bytes of dynamic shared memory): the weights, then each of the
    ``GROUPS`` groups' k-major activations (the chain's widest input, or
    the 3 ca appearance products) and its buffers: ``chunk`` sigmas, two
    anchor colours, the unit's view rows and two flag rows, per tile
    row."""
    V = 3 + 6 * tb.view_pe
    act_g = GROUP_ROWS * max(tb.mlp_in, 3 * tb.ca, tb.hidden)
    raw_g = _pad4(GROUP_ROWS * (chunk + 6 + V + 2))
    return act_g, raw_g, 4 * (tb.offsets[-1] + GROUPS * (act_g + raw_g))


def check(tb: VMTables, chunk: int, group: int, B: int) -> None:
    """Raise unless the kernel takes these widths and settings."""
    _, _, smem = plan(tb, chunk)
    if (tb.cd % 4 or tb.ca % 4 or tb.app_dim > 32 or tb.hidden > 128
            or tb.hidden % (8 if tb.hidden > 64 else 4)
            or not 1 <= chunk <= MAX_CHUNK or group < 1 or B < 1
            or smem > SMEM_LIMIT):
        raise ValueError(
            f"vm_march: components {tb.cd} / {tb.ca} (multiples of 4), "
            f"app_dim {tb.app_dim} (<= 32), hidden {tb.hidden} (<= 128, a "
            f"multiple of 4, of 8 above 64), chunk {chunk} (1 .. "
            f"{MAX_CHUNK}), group {group}, blocks of {B}: {smem} B of "
            f"shared memory (<= {SMEM_LIMIT})")


# Ray-anchors evaluated by every launch since the last reset, per device:
# (1,) int64 tensors that the kernel adds to atomically (the plain
# version's wrapper on the CPU), read only by ``anchor_count``.
_anchor_totals: dict = {}


def _anchor_total(dev):
    t = _anchor_totals.get(dev)
    if t is None:
        t = _anchor_totals[dev] = torch.zeros((1,), dtype=torch.int64,
                                              device=dev)
    return t


def anchor_count() -> int:
    """Ray-anchors the VM march evaluated, all launches and devices,
    since ``reset_anchor_count`` (synchronizes with the devices)."""
    with _build.launch_lock:
        return sum(int(t) for t in _anchor_totals.values())


def reset_anchor_count() -> None:
    with _build.launch_lock:
        for t in _anchor_totals.values():
            t.zero_()


def _fn():
    fn = _build.library("vm_march").vm_march_launch
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = [P] * 13 + [ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_float), P]
        fn.restype = ctypes.c_int
    return fn


def vm_march(o, d, view, budgets, tb: VMTables, *, block_size, chunk, group,
             near, far, log_eps_t, early_term=True, white_background=True,
             with_color=True, per_ray_exit=False):
    """o/d (N*B, 3), view (N*B, 3 + 6 view_pe) (None without colour),
    budgets (N,) i32, the field's ``VMTables`` -> (rows (N*B, 8), ray-
    anchors evaluated per block (N,) int32), their sum added to
    ``anchor_count``.  CUDA tensors launch the kernel; CPU tensors run
    ``vm_march_plain``."""
    kw = dict(block_size=block_size, chunk=chunk, group=group, near=near,
              far=far, log_eps_t=log_eps_t, early_term=early_term,
              white_background=white_background, with_color=with_color,
              per_ray_exit=per_ray_exit)
    if o.device.type == "cpu":
        out, anchors = vm_march_plain(o, d, view, budgets, tb, **kw)
        with _build.launch_lock:
            _anchor_total(o.device).add_(anchors.sum())
        return out, anchors
    dev = o.device
    N, B = budgets.shape[0], block_size
    V = 3 + 6 * tb.view_pe
    for name, t, dt, nd in (("o", o, torch.float32, 2), ("d", d, torch.float32, 2),
                            ("budgets", budgets, torch.int32, 1),
                            ("dplane", tb.dplane, torch.float32, 1),
                            ("dline", tb.dline, torch.float32, 1),
                            ("aplane", tb.aplane, torch.float32, 1),
                            ("aline", tb.aline, torch.float32, 1),
                            ("weights", tb.weights, torch.float32, 1)):
        _build.require(f"vm_march {name}", t, dt, nd, dev)
    if with_color:
        _build.require("vm_march view", view, torch.float32, 2, dev)
        if tuple(view.shape) != (N * B, V):
            raise ValueError(f"vm_march: view rows {tuple(view.shape)}, "
                             f"want ({N * B}, {V})")
    if tuple(o.shape) != (N * B, 3) or tuple(d.shape) != (N * B, 3):
        raise ValueError(f"vm_march: rays {tuple(o.shape)} for {N} blocks "
                         f"of {B}")
    check(tb, chunk, group, B)
    act_g, raw_g, smem = plan(tb, chunk)
    with _build.launch_lock:
        total = _anchor_total(dev)
    out = torch.zeros((N * B, OUT_W), dtype=torch.float32, device=dev)
    anchors = torch.zeros((N,), dtype=torch.int32, device=dev)
    sync = torch.zeros((SYNC_WORDS + N,), dtype=torch.int32, device=dev)
    ints = (ctypes.c_int * 29)(
        N, B, chunk, group, tb.cd, tb.ca, tb.app_dim, tb.hidden, tb.mlp_in,
        tb.fea_pe, tb.view_pe, V, *tb.res, int(early_term),
        int(white_background), int(with_color), int(per_ray_exit),
        *tb.offsets, act_g, raw_g, smem)
    floats = (ctypes.c_float * 6)(near, far - near, far, log_eps_t,
                                  tb.sigma_scale, tb.density_shift)
    with torch.cuda.device(dev):
        err = _fn()(o.data_ptr(), d.data_ptr(),
                    view.data_ptr() if with_color else None,
                    budgets.data_ptr(), tb.dplane.data_ptr(),
                    tb.dline.data_ptr(), tb.aplane.data_ptr(),
                    tb.aline.data_ptr(), tb.weights.data_ptr(),
                    out.data_ptr(), sync.data_ptr(), anchors.data_ptr(),
                    total.data_ptr(), ints, floats, _build.stream_ptr(dev))
    _build.check(err, "vm_march")
    _build.count_launch(vm_march)
    return out, anchors


vm_march.launches = 0
