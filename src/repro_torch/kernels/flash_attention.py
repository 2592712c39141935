"""Causal GQA flash attention: CUDA kernel + plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py``
``flash_attention`` (``_flash_kernel``) of the LM side.  q (B, S, H, Dh),
k/v (B, S, KV, Dh) with H a multiple of KV; scores scaled by Dh**-0.5, an
optional tanh ``softcap``, causal with an optional sliding ``window``
(0 = global); fp32 math, the output in q's dtype (fp32 or bf16).

The CUDA kernel (``csrc/flash_attention.cu``, built by ``_build.py`` with
nvcc for sm_90a) has two instantiations.  bf16 inputs run FA2-style on the
tensor cores: a warp owns 16 query rows, ``mma.sync`` m16n8k16 bf16 ->
fp32 for Q.K^T and P.V, K and V by ``ldmatrix`` (V transposed), the online
softmax on the fp32 accumulator fragments, and P rounded to bf16 in
registers as the A operand of P.V.  fp32 inputs stay in full fp32 on the
CUDA cores as a register-tiled outer product (4 x 4 of S and 4 x 16 of O
per thread).  Both stream double-buffered K/V tiles by ``cp.async``, read
KV head ``h // (H // KV)`` in place and skip key tiles the masks empty
(``key_tiles``).  Bound on the H100: operations, on the tensor cores for
bf16 and on the fp32 pipes for fp32.

``flash_attention`` launches the kernel for CUDA tensors and uses
``flash_attention_plain`` only for tensors on the CPU.  The plain version
runs the same online softmax over key tiles in torch (for bf16 inputs with
P rounded to bf16 before P.V, as the kernel does); the kernel is held to
it by tolerance (rtol 2e-4 / atol 2e-5 in fp32; rtol 1e-2 / atol 8e-3 in
bf16, with the error's norm at most 3e-3 of the output's), not to the
bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
PLAIN_KEY_TILE = 128
MAX_HEAD_DIM = 128
# the kernel's tiles, by input dtype: query rows per CTA, keys per tile
QUERY_TILE = {torch.bfloat16: 128, torch.float32: 64}
KEY_TILE = {torch.bfloat16: 64, torch.float32: 32}
F32_P_ROW = KEY_TILE[torch.float32] + 8     # floats of a row of the P tile


def grid(B: int, S: int, H: int, dtype) -> tuple:
    """The launch grid: (query tiles, B * H)."""
    return -(-S // QUERY_TILE[dtype]), B * H


def key_tiles(q0: int, S: int, window: int, dtype) -> range:
    """The wrapper's reckoning of the first keys of the key tiles the CTA of
    query rows [q0, q0 + QUERY_TILE) loads: from the tile holding key
    q0 - window + 1 (0 without a window) up to the last key of its rows,
    min(S, q0 + QUERY_TILE) - 1.  ``launched_key_tiles`` is the kernel's."""
    kb = KEY_TILE[dtype]
    begin = max(0, q0 - window + 1) // kb * kb if window > 0 else 0
    return range(begin, min(S, q0 + QUERY_TILE[dtype]), kb)


def launched_key_tiles(q0: int, S: int, window: int, dtype) -> range:
    """The key tiles the compiled kernels load for the CTA of query rows
    [q0, q0 + QUERY_TILE), from the range function they use; builds the
    library."""
    fn = _build.library("flash_attention").flash_attention_key_range
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    out = (ctypes.c_longlong * 2)()
    fn(int(dtype == torch.bfloat16), q0, S, window, out)
    return range(int(out[0]), int(out[1]), KEY_TILE[dtype])


def smem_bytes(Dh: int, dtype) -> int:
    """Dynamic shared memory of the kernel: two buffers each of a K and a V
    tile, rows padded by 16 B; for bf16 Q's tile is staged in the second
    buffer (read into registers before it first fills), for fp32 it has
    its own, and the P tile."""
    qb, kb = QUERY_TILE[dtype], KEY_TILE[dtype]
    if dtype == torch.bfloat16:
        return 2 * (Dh + 8) * 4 * kb
    return 4 * ((Dh + 4) * (qb + 4 * kb) + qb * F32_P_ROW)


def launch_config(Dh: int, B: int, S: int, H: int, dtype) -> tuple:
    """What the compiled launcher uses: (query rows per CTA, keys per tile,
    shared memory bytes, grid x, grid y); builds the library."""
    fn = _build.library("flash_attention").flash_attention_config
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    out = (ctypes.c_longlong * 5)()
    fn(int(dtype == torch.bfloat16), Dh, B, S, H, out)
    return tuple(int(x) for x in out)


def flash_attention_plain(q, k, v, window: int = 0, softcap: float = 0.0):
    """The kernel's function in torch: an online softmax over key tiles,
    fp32 statistics; for bf16 inputs P is rounded to bf16 before P.V."""
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
        if q.dtype == torch.bfloat16:    # the kernel's P.V takes P in bf16
            p = p.to(torch.bfloat16).float()
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
    _build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
