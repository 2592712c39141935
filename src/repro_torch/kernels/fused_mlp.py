"""Density and color MLPs: CUDA kernels + plain PyTorch versions.

Replaces the TPU kernels ``repro/kernels/fused_mlp.py`` ``density_call``
(``_density_kernel``), ``color_call`` (``_color_kernel``) and
``fused_field_call`` (``_fused_kernel``: both chains in one pass, packed
``[sigma, rgb, geo]``).  The CUDA kernels are in ``csrc/fused_mlp.cu``,
built by ``_build.py`` with nvcc for sm_90a.  All three are
register-tiled chains: one persistent CTA per SM holds the weights in
shared memory and walks over tiles of samples, ``TILE_ROWS`` in flight,
whose activations sit k-major beside the weights; each thread keeps a
small tile of a layer's outputs in registers (``density_smem_bytes`` /
``color_smem_bytes`` / ``fused_smem_bytes``).  The density kernel stages
each tile's output rows in shared memory and writes them out contiguous.
Bound on the H100: operations (fp32 on the CUDA cores; 74,240 FLOP per
color sample at the paper's widths).

Weights keep their true widths: a chain is packed flat, layer after layer,
each a row-major (fan_in, fan_out) matrix, with its widths beside it
(``pack_chain``).  The TPU's 128-lane padding and sigma-column
permutation are not carried over.

Each wrapper launches its kernel for CUDA tensors and uses the plain
version only for CPU tensors.  The plain versions repeat the kernels'
arithmetic, so on the card they agree to the bit.  Every dense layer
sums its products in order, k = 0 first, from 0.  The density chain
rounds each product and each sum on its own (``dense_plain``, as the
fused march does); the color chain rounds once per multiply-add, as
``fmaf`` does (``dense_plain_fma``).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build

MAX_WIDTH = 128
MAX_LAYERS = 8
SMEM_LIMIT = 232448          # bytes of shared memory one CTA may use (H100)
TILE_ROWS = 64               # samples in flight per CTA (the MLP kernels)


def pack_chain(weights: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """[(fan_in, fan_out) ...] -> (flat float32 weights, widths)."""
    dims = (int(weights[0].shape[0]),) + tuple(int(w.shape[1]) for w in weights)
    flat = torch.cat([w.float().contiguous().reshape(-1) for w in weights])
    return flat, dims


def chain_size(dims) -> int:
    """Number of weights of a chain of widths ``dims``."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def unpack_chain(flat, dims):
    out, off = [], 0
    for a, b in zip(dims[:-1], dims[1:]):
        out.append(flat[off:off + a * b].reshape(a, b))
        off += a * b
    return out


def dense_plain(x, w):
    """x (N, n_in) @ w (n_in, n_out), summed over k in order."""
    y = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                    device=x.device)
    for k in range(w.shape[0]):
        y = y + x[:, k:k + 1] * w[k]
    return y


_LOW29 = (1 << 29) - 1        # float64 mantissa bits below float32's
_HALF29 = 1 << 28             # ... holding exactly half a float32 ulp
_TINY32 = 2.0 ** -126         # below: float32 subnormals, other spacing


def _round_once(p, c):
    """float32 of the exact p + c, rounded once to nearest, ties to even;
    p float64 (an exact product of two float32s), c float32.

    The float64 sum ``s`` rounds at most once, and rounding it to float32
    again is right unless ``s`` lies exactly on a float32 midpoint (its
    mantissa bits below float32's are 1000...0) or in the subnormal range.
    Only there is the sum redone: TwoSum gives its error ``e``, ``s``
    becomes round-to-odd (the neighbour on ``e``'s side where ``s`` is
    even and ``e != 0``), and round-to-odd in 53 bits followed by
    round-to-nearest in 24 is the correctly rounded result."""
    s = p + c
    r = s.float()
    need = ((s.view(torch.int64) & _LOW29) == _HALF29) | (
        (r.abs() <= _TINY32) & (s != 0))
    if bool(need.any()):
        p, c = torch.broadcast_tensors(p, c.double())
        pn, cn, sn = p[need], c[need], s[need]
        bb = sn - pn
        e = (pn - (sn - bb)) + (cn - bb)
        bits = sn.view(torch.int64)
        odd = torch.where((e != 0) & ((bits & 1) == 0),
                          bits + torch.where((e > 0) == (sn > 0), 1, -1), bits)
        r[need] = odd.view(torch.float64).float()
    return r


def fma_plain(a, b, c):
    """fmaf(a, b, c) elementwise on float32 tensors (broadcasting): the
    exact a*b + c rounded once to the nearest float32, ties to even.  The
    float64 product of two float32s is exact."""
    return _round_once(a.double() * b.double(), c)


def _dense_fma_exact(x64, w64):
    y = torch.zeros((x64.shape[0], w64.shape[1]), dtype=torch.float32,
                    device=x64.device)
    for k in range(w64.shape[0]):
        y = _round_once(torch.outer(x64[:, k], w64[k]), y)
    return y


def _min_exponent(t) -> int:
    """The least frexp exponent of t's entries (0 counts as exponent 0)."""
    return int(torch.frexp(t).exponent.min()) if t.numel() else 0


def dense_plain_fma(x, w, rows: int = 4096):
    """x (N, n_in) @ w (n_in, n_out), summed over k in order from 0 with
    one rounding per multiply-add: y = fmaf(x[:, k], w[k], y).

    Each step rounds the float64 sum to float32 (5 tensor ops) and flags
    the sums that lie on a float32 midpoint, where that rounds twice; the
    rows flagged are redone with ``fma_plain``'s exact step.  Sums in the
    subnormal range round once as they are: every partial sum is a
    multiple of lsb(x) * lsb(w) >= 2^(e_x + e_w - 48), so where e_x + e_w
    >= -130 (least frexp exponents) a sum below 2^-126 is exact in
    float64; a block of rows that misses that bound takes the exact step
    throughout.  On the CPU, blocks of ``rows`` rows keep each step's
    float64 temporaries in cache."""
    w64 = w.double()
    ew = _min_exponent(w)
    step = rows if x.device.type == "cpu" else max(x.shape[0], 1)
    out = []
    for s0 in range(0, x.shape[0], step):
        xb = x[s0:s0 + step]
        x64 = xb.double()
        if _min_exponent(xb) + ew < -130:
            out.append(_dense_fma_exact(x64, w64))
            continue
        y = torch.zeros((xb.shape[0], w.shape[1]), dtype=torch.float32,
                        device=x.device)
        flag = torch.zeros(y.shape, dtype=torch.bool, device=x.device)
        for k in range(w.shape[0]):
            s = torch.addcmul(y, x64[:, k:k + 1], w64[k])
            y = s.float()
            flag |= (s.view(torch.int64) & _LOW29) == _HALF29
        redo = flag.any(1)
        if bool(redo.any()):
            y[redo] = _dense_fma_exact(x64[redo], w64)
        out.append(y)
    return torch.cat(out) if out else torch.zeros(
        (0, w.shape[1]), dtype=torch.float32, device=x.device)


def chain_plain(x, flat, dims, dense=dense_plain):
    """The chain with ``dense`` for each layer, ReLU between layers."""
    ws = unpack_chain(flat, dims)
    for i, w in enumerate(ws):
        x = dense(x, w)
        if i < len(ws) - 1:
            x = torch.relu(x)
    return x


def trunc_exp_plain(x):
    return torch.exp(torch.clamp(x, -15.0, 15.0))


def sigmoid_plain(x):
    return torch.reciprocal(1.0 + torch.exp(-x))


def density_mlp_plain(enc, flat, dims):
    """enc (N, d0) -> (N, 1+G) packed [trunc_exp(sigma logit), geo]."""
    out = chain_plain(enc, flat, dims)
    return torch.cat([trunc_exp_plain(out[:, :1]), out[:, 1:]], dim=1)


def color_mlp_plain(cin, flat, dims):
    """cin (N, G+S) = [geo, SH(dir)] -> rgb (N, 3), one rounding per
    multiply-add."""
    return sigmoid_plain(chain_plain(cin, flat, dims, dense_plain_fma))


def fused_field_plain(enc, sh, wd, dims_d, wc, dims_c):
    """enc (N, d0), sh (N, S) -> (N, 4+G) packed [sigma, rgb, geo]: the
    density chain, then the color chain on [geo, sh]."""
    dout = density_mlp_plain(enc, wd, dims_d)
    rgb = color_mlp_plain(torch.cat([dout[:, 1:], sh], dim=1), wc, dims_c)
    return torch.cat([dout[:, :1], rgb, dout[:, 1:]], dim=1)


def check_tile_dims(dims) -> None:
    """Raise unless the tile kernels take a chain of widths ``dims``: at
    most ``MAX_LAYERS`` layers of width <= ``MAX_WIDTH``, hidden widths
    multiples of 4 (a thread's 4 columns of weights are one float4), and
    of 8 above 64 (8 columns a thread)."""
    if len(dims) - 1 > MAX_LAYERS or max(dims) > MAX_WIDTH:
        raise ValueError(f"MLP widths {dims}: the kernels take at most "
                         f"{MAX_LAYERS} layers of width <= {MAX_WIDTH}")
    if any(d % (8 if d > 64 else 4) for d in dims[1:-1]):
        raise ValueError(f"MLP widths {dims}: the tile kernels take hidden "
                         f"widths that are multiples of 4 (of 8 above 64)")


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def color_smem_bytes(dims, rows: int = TILE_ROWS) -> int:
    """Dynamic shared memory of the color kernel: the chain's weights, the
    k-major activations of a tile (its widest layer input) and two input
    tiles (one filling while the other computes)."""
    return 4 * (_pad4(chain_size(dims)) + rows * max(dims[:-1])
                + 2 * rows * dims[0])


def density_smem_bytes(dims, rows: int = TILE_ROWS) -> int:
    """Dynamic shared memory of the density kernel: the color kernel's
    plan for its chain, and a staging tile of output rows (each one float
    wider, so a column's stores spread over the banks)."""
    return color_smem_bytes(dims, rows) + 4 * rows * (dims[-1] + 1)


def two_chain_floats(dims_d, dims_c, rows: int = TILE_ROWS) -> int:
    """Floats of both chains' weights and of the k-major activations of the
    two-chain kernels (fused field, fused march): the color input sits
    past the density chain's widest input."""
    p = max(dims_d[:-1])
    act = max(p + dims_c[0], max(dims_c[:-1]))
    return (_pad4(chain_size(dims_d)) + _pad4(chain_size(dims_c))
            + rows * act)


def fused_smem_bytes(dims_d, dims_c, rows: int = TILE_ROWS) -> int:
    """Dynamic shared memory of the fused-field kernel: both chains'
    weights, the activations and two input tiles of enc and sh rows."""
    S = dims_c[0] - (dims_d[-1] - 1)
    return 4 * (two_chain_floats(dims_d, dims_c, rows)
                + 2 * rows * (dims_d[0] + S))


def check_color_chain(dims) -> None:
    """Raise unless the color kernel takes a chain of widths ``dims``."""
    check_tile_dims(dims)
    check_smem("color_mlp", color_smem_bytes(dims), dims)


def check_density_chain(dims) -> None:
    """Raise unless the density kernel takes a chain of widths ``dims``."""
    check_tile_dims(dims)
    check_smem("density_mlp", density_smem_bytes(dims), dims)


def check_fused_chains(dims_d, dims_c) -> None:
    """Raise unless the fused-field kernel takes these two chains."""
    check_tile_dims(dims_d)
    check_tile_dims(dims_c)
    check_smem("fused_field", fused_smem_bytes(dims_d, dims_c),
               (dims_d, dims_c))


def check_smem(name, smem, dims):
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: widths {dims} need {smem} B of shared "
                         f"memory (> {SMEM_LIMIT})")


def _aligned(t):
    """``t`` itself if its data is 16-B aligned (the kernels copy input
    rows with 16-B cp.async), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fn(name):
    fn = getattr(_build.library("fused_mlp"), name)
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = [P, ctypes.c_longlong, P, ctypes.POINTER(ctypes.c_int),
                       ctypes.c_int, P, P]
        fn.restype = ctypes.c_int
    return fn


def _launch(name, x, flat, dims, check):
    dev = x.device
    _build.require(f"{name} input", x, torch.float32, 2, dev)
    _build.require(f"{name} weights", flat, torch.float32, 1, dev)
    check(dims)
    if x.shape[1] != dims[0] or flat.numel() != chain_size(dims):
        raise ValueError(f"{name}: input {tuple(x.shape)} / weights "
                         f"{flat.numel()} do not match widths {dims}")
    out = torch.empty((x.shape[0], dims[-1]), dtype=torch.float32, device=dev)
    x = _aligned(x)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(dev):
        err = _fn(f"{name}_launch")(x.data_ptr(), x.shape[0], flat.data_ptr(),
                                    c_dims, len(dims) - 1, out.data_ptr(),
                                    _build.stream_ptr(dev))
    _build.check(err, name)
    return out


def density_launch_smem(dims) -> int:
    """Bytes of shared memory the density kernel's launcher asks for (the
    compiled library's own reckoning; builds it)."""
    fn = _build.library("fused_mlp").density_mlp_smem
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn((ctypes.c_int * len(dims))(*dims), len(dims) - 1))


def density_mlp(enc, flat, dims):
    """enc (N, d0) -> (N, 1+G) packed [sigma, geo]; sigma = trunc_exp of
    the logit in column 0.  CUDA tensors launch the kernel."""
    if enc.device.type == "cpu":
        return density_mlp_plain(enc, flat, dims)
    out = _launch("density_mlp", enc, flat, dims, check_density_chain)
    _build.count_launch(density_mlp)
    return out


def color_mlp(cin, flat, dims):
    """cin (N, G+S) = [geo, SH(dir)] -> rgb (N, 3) after a sigmoid.  CUDA
    tensors launch the kernel."""
    if cin.device.type == "cpu":
        return color_mlp_plain(cin, flat, dims)
    out = _launch("color_mlp", cin, flat, dims, check_color_chain)
    _build.count_launch(color_mlp)
    return out


def fused_field(enc, sh, wd, dims_d, wc, dims_c):
    """enc (N, d0), sh (N, S) -> (N, 4+G) packed [sigma, rgb, geo].  CUDA
    tensors launch the kernel."""
    if enc.device.type == "cpu":
        return fused_field_plain(enc, sh, wd, dims_d, wc, dims_c)
    dev = enc.device
    for name, t, nd in (("enc", enc, 2), ("sh", sh, 2), ("wd", wd, 1),
                        ("wc", wc, 1)):
        _build.require(f"fused_field {name}", t, torch.float32, nd, dev)
    n, S, G = enc.shape[0], sh.shape[1], dims_d[-1] - 1
    if (enc.shape[1] != dims_d[0] or sh.shape[0] != n
            or dims_c[0] != G + S or dims_c[-1] != 3
            or wd.numel() != chain_size(dims_d)
            or wc.numel() != chain_size(dims_c)):
        raise ValueError(
            f"fused_field: enc {tuple(enc.shape)}, sh {tuple(sh.shape)}, "
            f"widths {dims_d} / {dims_c}, weights {wd.numel()} / "
            f"{wc.numel()}")
    check_fused_chains(dims_d, dims_c)
    enc, sh = _aligned(enc), _aligned(sh)
    out = torch.empty((n, 4 + G), dtype=torch.float32, device=dev)
    fn = _build.library("fused_mlp").fused_field_launch
    if fn.argtypes is None:
        P, IP = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [P, P, ctypes.c_longlong, ctypes.c_int, P, IP,
                       ctypes.c_int, P, IP, ctypes.c_int, P, P]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(enc.data_ptr(), sh.data_ptr(), n, S, wd.data_ptr(),
                 (ctypes.c_int * len(dims_d))(*dims_d), len(dims_d) - 1,
                 wc.data_ptr(), (ctypes.c_int * len(dims_c))(*dims_c),
                 len(dims_c) - 1, out.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "fused_field")
    _build.count_launch(fused_field)
    return out


density_mlp.launches = 0
color_mlp.launches = 0
fused_field.launches = 0
