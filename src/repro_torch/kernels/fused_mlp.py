"""Density and color MLPs: CUDA kernels + plain PyTorch versions.

Replaces the TPU kernels ``repro/kernels/fused_mlp.py`` ``density_call``
(``_density_kernel``), ``color_call`` (``_color_kernel``) and
``fused_field_call`` (``_fused_kernel``: both chains in one pass, packed
``[sigma, rgb, geo]``).  The CUDA kernels (``csrc/fused_mlp.cu``, built by ``_build.py`` with nvcc for
sm_90a) copy a chain's weights into shared memory once per CTA and carry
one sample per thread through it.  Bound on the H100: operations (fp32 on
the CUDA cores; 74,240 FLOP per color sample at the paper's widths).

Weights keep their true widths: a chain is packed flat, layer after layer,
each a row-major (fan_in, fan_out) matrix, with its widths beside it
(``pack_chain``).  The TPU's 128-lane padding and sigma-column
permutation are not carried over.

Each wrapper launches its kernel for CUDA tensors and uses the plain
version only for CPU tensors.  The plain versions repeat the kernels'
arithmetic (a dense layer sums its products in order, k = 0 first, with
each product and sum rounded on its own), so on the card they agree to
the bit.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build

MAX_WIDTH = 128
MAX_LAYERS = 8
SMEM_LIMIT = 232448          # bytes of shared memory one CTA may use (H100)


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


def chain_plain(x, flat, dims):
    ws = unpack_chain(flat, dims)
    for i, w in enumerate(ws):
        x = dense_plain(x, w)
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
    """cin (N, G+S) = [geo, SH(dir)] -> rgb (N, 3)."""
    return sigmoid_plain(chain_plain(cin, flat, dims))


def fused_field_plain(enc, sh, wd, dims_d, wc, dims_c):
    """enc (N, d0), sh (N, S) -> (N, 4+G) packed [sigma, rgb, geo]: the
    density chain, then the color chain on [geo, sh]."""
    dout = density_mlp_plain(enc, wd, dims_d)
    rgb = color_mlp_plain(torch.cat([dout[:, 1:], sh], dim=1), wc, dims_c)
    return torch.cat([dout[:, :1], rgb, dout[:, 1:]], dim=1)


def check_dims(dims) -> None:
    if len(dims) - 1 > MAX_LAYERS or max(dims) > MAX_WIDTH:
        raise ValueError(f"MLP widths {dims}: the kernels take at most "
                         f"{MAX_LAYERS} layers of width <= {MAX_WIDTH}")


def _fn(name):
    fn = getattr(_build.library("fused_mlp"), name)
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = [P, ctypes.c_longlong, P, ctypes.POINTER(ctypes.c_int),
                       ctypes.c_int, P, P]
        fn.restype = ctypes.c_int
    return fn


def _launch(name, x, flat, dims):
    dev = x.device
    _build.require(f"{name} input", x, torch.float32, 2, dev)
    _build.require(f"{name} weights", flat, torch.float32, 1, dev)
    check_dims(dims)
    if x.shape[1] != dims[0] or flat.numel() != chain_size(dims):
        raise ValueError(f"{name}: input {tuple(x.shape)} / weights "
                         f"{flat.numel()} do not match widths {dims}")
    out = torch.empty((x.shape[0], dims[-1]), dtype=torch.float32, device=dev)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(dev):
        err = _fn(f"{name}_launch")(x.data_ptr(), x.shape[0], flat.data_ptr(),
                                    c_dims, len(dims) - 1, out.data_ptr(),
                                    _build.stream_ptr(dev))
    _build.check(err, name)
    return out


def density_mlp(enc, flat, dims):
    """enc (N, d0) -> (N, 1+G) packed [sigma, geo]; sigma = trunc_exp of
    the logit in column 0.  CUDA tensors launch the kernel."""
    if enc.device.type == "cpu":
        return density_mlp_plain(enc, flat, dims)
    out = _launch("density_mlp", enc, flat, dims)
    density_mlp.launches += 1
    return out


def color_mlp(cin, flat, dims):
    """cin (N, G+S) = [geo, SH(dir)] -> rgb (N, 3) after a sigmoid.  CUDA
    tensors launch the kernel."""
    if cin.device.type == "cpu":
        return color_mlp_plain(cin, flat, dims)
    out = _launch("color_mlp", cin, flat, dims)
    color_mlp.launches += 1
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
    check_dims(dims_d)
    check_dims(dims_c)
    n, S, G = enc.shape[0], sh.shape[1], dims_d[-1] - 1
    smem = 4 * (chain_size(dims_d) + chain_size(dims_c))
    if (enc.shape[1] != dims_d[0] or sh.shape[0] != n
            or dims_c[0] != G + S or dims_c[-1] != 3
            or wd.numel() != chain_size(dims_d)
            or wc.numel() != chain_size(dims_c) or smem > SMEM_LIMIT):
        raise ValueError(
            f"fused_field: enc {tuple(enc.shape)}, sh {tuple(sh.shape)}, "
            f"widths {dims_d} / {dims_c}, weights {wd.numel()} / "
            f"{wc.numel()}, {smem} B of shared memory (<= {SMEM_LIMIT})")
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
    fused_field.launches += 1
    return out


density_mlp.launches = 0
color_mlp.launches = 0
fused_field.launches = 0
