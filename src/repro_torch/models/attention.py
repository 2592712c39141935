"""GQA attention (``repro.models.attention``): RoPE, qk-norm, logit
softcap, sliding windows, KV caches.

Three execution paths, as in the reference:
  * ``attend_full``    — masked O(S^2) attention (decode, small S);
  * ``attend_chunked`` — the online-softmax scan over KV chunks, with an
    optional ``extra_mask``;
  * ``decode_attend``  — one query token against a (possibly ring) cache.
Prefill self-attention without an ``extra_mask`` goes through the
attention function the model was built with (``lm.build``: the flash
kernel by default); these are the reference's own paths.
``attend_causal`` is the reference's causal call of ``attend_chunked``
with that function's signature: the training route.

Positions are int64 here (int32 in the reference); a padded or empty slot
holds ``INVALID_POS``, the reference's int32 maximum.  A window is a
Python int per layer (0 = global): the port unrolls layers eagerly, where
the reference scans them with a traced window.

Caches: global layers use a linear cache (B, S_max, KV*Dh); local layers
a ring of ``window`` slots, written at ``pos % window``, whose absolute
positions come back from the slots' ages.  ``cache_update`` writes the
step into the cache's storage in place and returns it: the reference
returns a new cache and never reads the old one again, and an in-place
write keeps one copy of a full-width cache (7 GB at gemma2-27b's wave of
four 4,648-token slots) instead of two.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30
INVALID_POS = 2 ** 31 - 1


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    return torch.pow(theta, exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x (..., S, H, Dh), positions (..., S) integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _mask(q_pos, k_pos, window: int):
    """Causal + optional sliding-window mask (window 0 = global).
    q_pos (Q,), k_pos (K,) -> bool (Q, K)."""
    diff = q_pos[:, None] - k_pos[None, :]
    causal = diff >= 0
    if window > 0:
        return causal & (diff < window)
    return causal


def _qk_scores(q, k, scale, softcap_val):
    """q (B,Q,H,Dh), k (B,K,KV,Dh) -> scores (B,KV,rep,Q,K), GQA."""
    B, Q, H, Dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Q, KV, H // KV, Dh)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * scale
    if softcap_val:
        s = softcap_val * torch.tanh(s / softcap_val)
    return s


def _weighted_v(p, v):
    """p (B,KV,rep,Q,K), v (B,K,KV,Dh) -> (B,Q,H,Dh)."""
    B, KV, rep, Q, K = p.shape
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return out.reshape(B, Q, KV * rep, -1)


def attend_full(q, k, v, q_pos, k_pos, window: int = 0,
                softcap_val: float = 0.0, extra_mask=None):
    """Masked attention over all K keys (materialises the scores)."""
    scale = q.shape[-1] ** -0.5
    s = _qk_scores(q, k, scale, softcap_val)
    m = _mask(q_pos, k_pos, window)
    if extra_mask is not None:
        m = m | extra_mask
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _weighted_v(p, v).to(q.dtype)


def attend_chunked(q, k, v, q_pos, k_pos, window: int = 0,
                   softcap_val: float = 0.0, chunk: int = 1024,
                   extra_mask=None):
    """The online softmax over KV chunks of ``chunk`` keys, op for op as
    the reference's scan (a ragged last chunk padded with invalid keys).

    q (B,Q,H,Dh); k/v (B,K,KV,Dh); q_pos (Q,), k_pos (K,); extra_mask an
    optional bool (Q, K) OR'd into the causal/window mask.
    """
    B, Q, H, Dh = q.shape
    K, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = Dh ** -0.5
    nchunks = -(-K // chunk)
    pad = nchunks * chunk - K
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=INVALID_POS)
        if extra_mask is not None:
            extra_mask = torch.nn.functional.pad(extra_mask, (0, pad))
    qg = q.reshape(B, Q, KV, rep, Dh).float()
    m_run = torch.full((B, KV, rep, Q), NEG_INF, device=q.device)
    d_run = torch.zeros((B, KV, rep, Q), device=q.device)
    acc = torch.zeros((B, KV, rep, Q, Dh), device=q.device)
    for c in range(nchunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k[:, sl].float()) * scale
        if softcap_val:
            s = softcap_val * torch.tanh(s / softcap_val)
        msk = _mask(q_pos, k_pos[sl], window)
        if extra_mask is not None:
            msk = msk | extra_mask[:, sl]
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        d_run = d_run * alpha + p.sum(dim=-1)
        pv = torch.einsum("bgrqk,bkgd->bgrqd", p, v[:, sl].float())
        acc = acc * alpha[..., None] + pv
        m_run = m_new
    out = acc / torch.clamp_min(d_run[..., None], 1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Q, H, Dh)
    return out.to(q.dtype)


def attend_causal(q, k, v, window: int = 0, softcap: float = 0.0):
    """Causal (optionally windowed) self-attention over positions 0..S-1
    through ``attend_chunked`` in chunks of min(1024, S): the reference's
    own prefill and training call (``repro/models/transformer.py:138``),
    op for op.  Plain torch, so autograd runs through it: the training
    route (``train/step.py``), where the flash kernel has no backward."""
    S = q.shape[1]
    pos = torch.arange(S, dtype=torch.int64, device=q.device)
    return attend_chunked(q, k, v, pos, pos, window, softcap, min(1024, S))


# ------------------------------------------------------------------ caches
class KVCache(NamedTuple):
    """Flat storage (B, S_slots, KV*Dh).  Ring-ness is not stored: a cache
    is a ring iff its layer has window > 0 and at most ``window`` slots
    (``is_ring``)."""
    k: torch.Tensor
    v: torch.Tensor


def is_ring(window: int, slots: int) -> bool:
    return bool(window) and slots <= window


def init_cache(batch, slots, kv_heads, head_dim, dtype, device) -> KVCache:
    shape = (batch, slots, kv_heads * head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def cache_slot_positions(cache: KVCache, pos: int, ring: bool):
    """Absolute position of each slot given the stream position ``pos``.

    Linear: slot s holds position s (valid while s < pos).
    Ring:   slot s holds the latest p < pos with p % W == s, i.e.
            p = pos - 1 - ((pos - 1 - s) % W).
    """
    S = cache.k.shape[1]
    s = torch.arange(S, dtype=torch.int64, device=cache.k.device)
    if not ring:
        return torch.where(s < pos, s, INVALID_POS)
    p = pos - 1 - torch.remainder(pos - 1 - s, S)
    return torch.where(p >= 0, p, INVALID_POS)


def cache_update(cache: KVCache, k_new, v_new, pos: int,
                 ring: bool) -> KVCache:
    """Write one step (B, 1, KV, Dh) at stream position ``pos`` into the
    cache's slot (pos % S on a ring) in place; returns the cache."""
    S = cache.k.shape[1]
    B = k_new.shape[0]
    slot = pos % S if ring else pos
    cache.k[:, slot] = k_new.reshape(B, -1).to(cache.k.dtype)
    cache.v[:, slot] = v_new.reshape(B, -1).to(cache.v.dtype)
    return cache


def decode_attend(q, cache: KVCache, pos: int, ring: bool, kv_heads: int,
                  window: int = 0, softcap_val: float = 0.0):
    """q (B,1,H,Dh) against the (already updated) cache; ``pos`` is the
    current token's position."""
    k_pos = cache_slot_positions(cache, pos + 1, ring)
    q_pos = torch.full((1,), pos, dtype=torch.int64, device=q.device)
    B, S = cache.k.shape[:2]
    k4 = cache.k.reshape(B, S, kv_heads, -1)
    v4 = cache.v.reshape(B, S, kv_heads, -1)
    return attend_full(q, k4, v4, q_pos, k_pos, window=window,
                       softcap_val=softcap_val)
