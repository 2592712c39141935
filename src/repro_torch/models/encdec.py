"""Whisper-style encoder-decoder backbone (``repro.models.encdec``).

The conv audio frontend is a stub, as in the reference: the batch feeds
precomputed frame embeddings (B, encoder_seq, d_model) (30 s of audio ->
1,500 frames at 50 Hz after the convolutions).  The backbone is whole: a
bidirectional encoder, a causal decoder with cross-attention, learned
absolute positions (``enc_pos``, ``dec_pos``), plain-GELU MLPs.

Attention routes, as the reference's: the encoder's bidirectional
attention and the cross-attention go through ``attend_chunked`` with an
all-true ``extra_mask``; the decoder's causal self-attention in
``decode_train`` goes through ``attend``, the attention function the model
was built with (``lm.build``: the flash kernel by default), which needs no
mask.  ``decode_step`` attends over the self cache with
``attention.decode_attend``.

Params keep the reference's layout: projections (d, H, Dh) and
(H, Dh, d), layers stacked on axis 0 under ``encoder`` and ``decoder``,
each drawn from the reference's key sequence through ``repro_torch.prng``
(so a key gives the reference's values), matrices stored in ``dtype``.

Serving: the cross K/V are computed once from the encoder output
(``prefill_cross``) and stay fixed; the decode cache carries the self K/V
(linear, ``max_seq`` slots) beside them.  ``decode_step`` writes a step's
self K/V into the cache in place and returns it (the reference returns a
new cache and never reads the old one again).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import prng
from ..device import resolve_device
from ..sharding.activation import constrain
from . import attention as attn
from . import ffn as ffn_lib
from . import params as pp
from .config import ModelConfig
from .params import P
from .transformer import compute_dtype, remat

DEC_POS = 32768     # decoder positions: the assigned shapes' 32k contexts


def _attn_init(key, cfg: ModelConfig, dtype, device):
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    ks = prng.split(key, 4)
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": pp.dense_init(ks[0], (d, H, Dh), ("d_model", "heads", "head_dim"),
                            **kw),
        "wk": pp.dense_init(ks[1], (d, KV, Dh),
                            ("d_model", "kv_heads", "head_dim"), **kw),
        "wv": pp.dense_init(ks[2], (d, KV, Dh),
                            ("d_model", "kv_heads", "head_dim"), **kw),
        "wo": pp.dense_init(ks[3], (H, Dh, d), ("heads", "head_dim", "d_model"),
                            **kw),
    }


def _norm(cfg: ModelConfig, device):
    return pp.zeros_init((cfg.d_model,), ("d_model",), device=device)


def _enc_layer_init(key, cfg: ModelConfig, dtype, device):
    ks = prng.split(key, 2)
    return {
        "pre_attn_norm": _norm(cfg, device),
        "attn": _attn_init(ks[0], cfg, dtype, device),
        "pre_ffn_norm": _norm(cfg, device),
        "ffn": ffn_lib.ffn_init(ks[1], cfg.d_model, cfg.d_ff, gated=False,
                                dtype=dtype, device=device),
    }


def _dec_layer_init(key, cfg: ModelConfig, dtype, device):
    ks = prng.split(key, 3)
    return {
        "pre_attn_norm": _norm(cfg, device),
        "attn": _attn_init(ks[0], cfg, dtype, device),
        "pre_cross_norm": _norm(cfg, device),
        "cross": _attn_init(ks[1], cfg, dtype, device),
        "pre_ffn_norm": _norm(cfg, device),
        "ffn": ffn_lib.ffn_init(ks[2], cfg.d_model, cfg.d_ff, gated=False,
                                dtype=dtype, device=device),
    }


def _positions(key, rows: int, cfg: ModelConfig, dtype, device) -> P:
    out = torch.empty((rows, cfg.d_model), dtype=dtype,
                      device=resolve_device(device))
    return P(prng.normal_into(out, key, 0.02), (None, "d_model"))


def model_init(key, cfg: ModelConfig, dtype=torch.float32, device=None):
    """Returns (values, axes), the reference's for the same key; matrices
    (and the position tables) stored in ``dtype``, norms in float32.  On
    the meta device nothing is drawn (``abstract_params``)."""
    E = cfg.encoder_layers
    ks = prng.split(key, E + cfg.n_layers + 4)
    tree = {
        "embed": pp.embed_init(ks[0], cfg.padded_vocab, cfg.d_model,
                               dtype=dtype, device=device),
        "enc_pos": _positions(ks[1], cfg.encoder_seq, cfg, dtype, device),
        "dec_pos": _positions(ks[2], DEC_POS, cfg, dtype, device),
        "enc_final_norm": _norm(cfg, device),
        "final_norm": _norm(cfg, device),
    }
    top_vals, top_axes = pp.split(tree)
    enc_v, enc_a = pp.stack_layers(
        lambda k: _enc_layer_init(k, cfg, dtype, device), ks[4:4 + E])
    dec_v, dec_a = pp.stack_layers(
        lambda k: _dec_layer_init(k, cfg, dtype, device), ks[4 + E:])
    return ({**top_vals, "encoder": enc_v, "decoder": dec_v},
            {**top_axes, "encoder": enc_a, "decoder": dec_a})


def abstract_params(cfg: ModelConfig):
    """(values on the meta device, axes): nothing allocated or drawn."""
    return model_init(torch.zeros(2, dtype=torch.int64), cfg, device="meta")


def _layer(stack, l: int):
    return pp.tree_map(lambda v: v[l], stack)


def _mha(p, xq, k, v, q_pos, k_pos, causal: bool, attend=None,
         chunk: int = 1024):
    """Attention of xq's queries over k/v, projected out.  Causal (the
    decoder's self-attention, q_pos = k_pos = 0..S-1) through ``attend``;
    bidirectional through ``attend_chunked`` with an all-true extra mask,
    which overrides causality."""
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"].to(xq.dtype))
    q = constrain(q, ("batch", "seq", "heads_act", None))
    if causal:
        out = attend(q, k, v, 0, 0.0)
    else:
        S, K = q_pos.shape[0], k_pos.shape[0]
        out = attn.attend_chunked(
            q, k, v, q_pos, k_pos, chunk=min(chunk, k.shape[1]),
            extra_mask=torch.ones((S, K), dtype=torch.bool, device=xq.device))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(xq.dtype))


def _kv(p, x):
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    return k, v


def _ffn(p, x, cfg: ModelConfig):
    h2 = pp.rms_norm(x, p["pre_ffn_norm"], cfg.norm_eps)
    return x + ffn_lib.ffn_apply(p["ffn"], h2, "gelu")


def encode(values, cfg: ModelConfig, frames):
    """frames (B, S_enc, D) stub embeddings -> encoder output (B, S_enc, D)."""
    dt = compute_dtype(cfg)
    x = frames.to(dt) + values["enc_pos"][None].to(dt)
    pos = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    for l in range(cfg.encoder_layers):
        p = _layer(values["encoder"], l)
        h = pp.rms_norm(x, p["pre_attn_norm"], cfg.norm_eps)
        k, v = _kv(p["attn"], h)
        x = x + _mha(p["attn"], h, k, v, pos, pos, causal=False)
        x = constrain(_ffn(p, x, cfg), ("batch", "seq", "embed_act"))
    return pp.rms_norm(x, values["enc_final_norm"], cfg.norm_eps)


def _logits(values, cfg: ModelConfig, x):
    x = pp.rms_norm(x, values["final_norm"], cfg.norm_eps)
    logits = torch.matmul(x, values["embed"].T.to(x.dtype)).float()
    if cfg.padded_vocab != cfg.vocab:
        logits[..., cfg.vocab:] = -1e30
    return logits


def decode_train(values, cfg: ModelConfig, tokens, enc_out, attend,
                 remat_policy: Optional[str] = None):
    """Teacher-forced decoder pass; causal self-attention through
    ``attend(q, k, v, window, softcap)``.  Returns logits (B, S, V).
    ``remat_policy`` wraps each decoder layer (``transformer.remat``;
    the reference's decoder takes "full" only and keeps everything
    otherwise, the port saves the matmuls under "dots" too): memory in
    backward only, the values do not depend on it."""
    S = tokens.shape[1]
    x = values["embed"][tokens].to(compute_dtype(cfg))
    x = x + values["dec_pos"][:S][None].to(x.dtype)
    pos = torch.arange(S, dtype=torch.int64, device=x.device)
    enc_pos = torch.arange(enc_out.shape[1], dtype=torch.int64,
                           device=x.device)

    def body(x, p, enc_out):
        h = pp.rms_norm(x, p["pre_attn_norm"], cfg.norm_eps)
        k, v = _kv(p["attn"], h)
        x = x + _mha(p["attn"], h, k, v, pos, pos, causal=True, attend=attend)
        hc = pp.rms_norm(x, p["pre_cross_norm"], cfg.norm_eps)
        ck, cv = _kv(p["cross"], enc_out)
        x = x + _mha(p["cross"], hc, ck, cv, pos, enc_pos, causal=False)
        return constrain(_ffn(p, x, cfg), ("batch", "seq", "embed_act"))

    layer = remat(body, remat_policy)
    for l in range(cfg.n_layers):
        x = layer(x, _layer(values["decoder"], l), enc_out)
    return constrain(_logits(values, cfg, x), ("batch", "seq", "vocab_act"))


class EncDecCache(NamedTuple):
    """Flat head storage (KV*Dh trailing axis), as ``attention.KVCache``."""
    self_k: torch.Tensor     # (L, B, S_max, KV*Dh)
    self_v: torch.Tensor
    cross_k: torch.Tensor    # (L, B, S_enc, KV*Dh)
    cross_v: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> EncDecCache:
    KV, Dh, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    dev = resolve_device(device)

    def zeros(seq):
        return torch.zeros((L, batch, seq, KV * Dh), dtype=dtype, device=dev)

    return EncDecCache(zeros(max_seq), zeros(max_seq), zeros(cfg.encoder_seq),
                       zeros(cfg.encoder_seq))


def decode_step(values, cfg: ModelConfig, cache: EncDecCache, token,
                pos: int):
    """One decoder step, token (B, 1) at position ``pos``, against the self
    and cross caches.  Returns (logits (B, 1, V), cache): the step's self
    K/V written into the cache in place."""
    B = token.shape[0]
    KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    x = values["embed"][token].to(compute_dtype(cfg))
    x = x + values["dec_pos"][pos:pos + 1][None].to(x.dtype)
    enc_pos = torch.arange(cache.cross_k.shape[2], dtype=torch.int64,
                           device=x.device)
    q_pos = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    for l in range(cfg.n_layers):
        p = _layer(values["decoder"], l)
        h = pp.rms_norm(x, p["pre_attn_norm"], cfg.norm_eps)
        k, v = _kv(p["attn"], h)
        cache.self_k[l, :, pos] = k.reshape(B, KV * Dh).to(cache.self_k.dtype)
        cache.self_v[l, :, pos] = v.reshape(B, KV * Dh).to(cache.self_v.dtype)
        q = torch.einsum("bsd,dhk->bshk", h, p["attn"]["wq"].to(h.dtype))
        a = attn.decode_attend(q, attn.KVCache(cache.self_k[l],
                                               cache.self_v[l]),
                               pos, ring=False, kv_heads=KV)
        x = x + torch.einsum("bshk,hkd->bsd", a, p["attn"]["wo"].to(h.dtype))
        hc = pp.rms_norm(x, p["pre_cross_norm"], cfg.norm_eps)
        ck4 = cache.cross_k[l].reshape(B, -1, KV, Dh).to(h.dtype)
        cv4 = cache.cross_v[l].reshape(B, -1, KV, Dh).to(h.dtype)
        x = x + _mha(p["cross"], hc, ck4, cv4, q_pos, enc_pos, causal=False)
        x = _ffn(p, x, cfg)
    return _logits(values, cfg, x), cache


def prefill_cross(values, cfg: ModelConfig, enc_out):
    """The fixed cross-attention K/V of every decoder layer, flat storage:
    (L, B, S_enc, KV*Dh) each."""
    B, S_enc, _ = enc_out.shape
    ck = cv = None
    for l in range(cfg.n_layers):
        k, v = _kv(_layer(values["decoder"], l)["cross"], enc_out)
        if ck is None:
            ck = k.new_empty((cfg.n_layers, B, S_enc, k.shape[2] * k.shape[3]))
            cv = torch.empty_like(ck)
        ck[l] = k.reshape(B, S_enc, -1)
        cv[l] = v.reshape(B, S_enc, -1)
    return ck, cv
