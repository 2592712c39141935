"""Causal GQA flash attention: CUDA kernel + plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py``
``flash_attention`` (``_flash_kernel``) of the LM side.  q (B, S, H, Dh),
k/v (B, S, KV, Dh) with H a multiple of KV; scores scaled by Dh**-0.5, an
optional tanh ``softcap``, causal with an optional sliding ``window``
(0 = global); fp32 math, the output in q's dtype (fp32 or bf16).

The CUDA kernel (``csrc/flash_attention.cu``, built by ``_build.py`` with
nvcc for sm_90a) runs one CTA per (batch*head, 64 query rows), streams
32-key tiles of K and V through shared memory and keeps the online
softmax on the CUDA cores; it reads KV head ``h // (H // KV)`` in place
and skips key tiles the masks empty.  Bound on the H100: operations.

``flash_attention`` launches the kernel for CUDA tensors and uses
``flash_attention_plain`` only for tensors on the CPU.  The plain version
runs the same online softmax over key tiles in torch; the kernel is held
to it by tolerance (rtol 2e-4 / atol 2e-5 in fp32), not to the bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
PLAIN_KEY_TILE = 128
MAX_HEAD_DIM = 128


def flash_attention_plain(q, k, v, window: int = 0, softcap: float = 0.0):
    """The kernel's function in torch: an online softmax over key tiles."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    rep = H // KV
    dev = q.device
    qf = (q.float() * Dh ** -0.5).reshape(B, S, KV, rep, Dh).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # (B, KV, 1, S, Dh)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    q_pos = torch.arange(S, device=dev)[:, None]
    m = torch.full((B, KV, rep, S), NEG_INF, device=dev)
    l = torch.zeros((B, KV, rep, S), device=dev)
    acc = torch.zeros((B, KV, rep, S, Dh), device=dev)
    for k0 in range(0, S, PLAIN_KEY_TILE):
        kb = kf[..., k0:k0 + PLAIN_KEY_TILE, :]
        vb = vf[..., k0:k0 + PLAIN_KEY_TILE, :]
        s = qf @ kb.transpose(-1, -2)                        # (B,KV,rep,S,kb)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        k_pos = torch.arange(k0, k0 + kb.shape[-2], device=dev)[None, :]
        keep = q_pos >= k_pos
        if window:
            keep = keep & (q_pos - k_pos < window)
        s = torch.where(keep, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(keep, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ vb
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)


def flash_attention(q, k, v, window: int = 0, softcap: float = 0.0):
    """q (B, S, H, Dh), k/v (B, S, KV, Dh) -> (B, S, H, Dh) in q's dtype.
    CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window, softcap)
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: fp32 or bf16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(f"flash_attention {name}", t, q.dtype, 4, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention {name}: not 16-byte aligned")
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    if (tuple(k.shape) != (B, S, KV, Dh) or k.shape != v.shape or KV < 1
            or H % KV or Dh % 16 or Dh > MAX_HEAD_DIM or B * H > 65535
            or window < 0 or softcap < 0):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} (H a multiple of KV, Dh a multiple of 16 up "
            f"to {MAX_HEAD_DIM}), window {window}, softcap {softcap}")
    out = torch.empty_like(q)
    fn = _build.library("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, ctypes.c_float,
                       ctypes.c_float, I, P]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 S, H, KV, Dh, int(window), float(softcap), Dh ** -0.5,
                 int(q.dtype == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
