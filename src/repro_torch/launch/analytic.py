"""Analytic FLOP/byte models per (arch, shape) cell
(``repro.launch.analytic``, the same closed forms over the port's
``ModelConfig`` and ``ShapeCell``).

These count what a step ACTUALLY executes — including remat
recomputation, GQA attention context, window clipping, MoE top-k routing,
and SSD chunk quadratics.  The reference reads them beside XLA's cost
analysis, which visits each scan body once; the port compiles nothing, so
they are its only FLOP and byte counts (``launch/dryrun.py``).

All numbers are GLOBAL (whole step, all chips); divide by chips for the
per-chip roofline term.
"""
from __future__ import annotations

from typing import Dict

from ..models.config import ModelConfig, ShapeCell


def _attn_context(S: int, window: int, kind: str) -> float:
    """Average attended KV length per query token."""
    if kind == "decode":
        ctx = float(S)              # one new token vs S-token cache
        return min(ctx, window) if window else ctx
    full_avg = (S + 1) / 2.0        # causal average
    if window and window < S:
        return (window + 1) / 2.0 + max(0.0, (S - window)) / S * (window / 2.0)
    return full_avg


def layer_forward_flops(cfg: ModelConfig, S: int, kind: str) -> Dict[str, float]:
    """Per-layer forward FLOPs for a single sequence of S tokens
    (decode: S=1 new token against a `ctx` cache)."""
    d = cfg.d_model
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    toks = 1 if kind == "decode" else S
    out: Dict[str, float] = {}

    if cfg.family != "ssm":
        qkv = 2 * toks * d * (H + 2 * KV) * Dh
        o = 2 * toks * H * Dh * d
        # attention scores+values (per-layer windows) are counted by the
        # caller, cell_flops
        out["attn_proj"] = qkv + o
    if cfg.family == "moe":
        out["ffn"] = (
            2 * toks * d * cfg.n_experts                       # router
            + 2 * 3 * toks * d * cfg.moe_d_ff
            * (cfg.top_k + cfg.n_shared_experts)
        )
    elif cfg.family != "ssm" and cfg.d_ff > 0:
        out["ffn"] = 2 * 3 * toks * d * cfg.d_ff
    if cfg.family in ("ssm", "hybrid"):
        di, N, Hs, Ps = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                         cfg.ssm_head_dim)
        proj = 2 * toks * d * (2 * di + 2 * N + Hs) + 2 * toks * di * d
        if kind == "decode":
            ssd = 4 * toks * Hs * Ps * N                     # state update+out
        else:
            Q = min(cfg.ssm_chunk, S)
            # intra-chunk quadratic (masked) + state path
            ssd = toks * Q * (2 * N + 2 * Hs * Ps) + 4 * toks * Hs * Ps * N
        out["ssm"] = proj + ssd
    return out


def cell_flops(cfg: ModelConfig, shape: ShapeCell,
               remat: bool = True) -> Dict[str, float]:
    """Global executed FLOPs for one step of this cell."""
    S, B = shape.seq_len, shape.global_batch
    kind = shape.kind
    toks = B * (1 if kind == "decode" else S)
    d = cfg.d_model
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    # layer_forward_flops is per sequence -> x layers x batch for global
    per_layer = layer_forward_flops(cfg, S, kind)
    body = sum(per_layer.values()) * cfg.n_layers * B

    # attention score/value FLOPs with per-layer windows
    attn_sv = 0.0
    if cfg.family != "ssm":
        for w in cfg.layer_kinds():
            ctx = _attn_context(S, w, kind)
            q_toks = 1 if kind == "decode" else S
            attn_sv += 2 * 2 * q_toks * H * Dh * ctx
        attn_sv *= B

    logits = 2 * toks * d * cfg.padded_vocab
    encoder = 0.0
    if cfg.is_encoder_decoder:
        Se = cfg.encoder_seq
        q_toks = 1 if kind == "decode" else S
        if kind != "decode":
            # encoder runs at train/prefill only; decode reuses cached
            # cross-K/V (plain GELU MLP: 2 matmuls, not 3)
            enc_layer = (2 * Se * d * (H + 2 * KV) * Dh
                         + 2 * Se * H * Dh * d
                         + 2 * 2 * Se * d * cfg.d_ff
                         + 2 * 2 * Se * H * Dh * (Se / 2))
            encoder = enc_layer * cfg.encoder_layers * B
            # cross-attention K/V projection over encoder output
            encoder += 2 * Se * d * 2 * KV * Dh * cfg.n_layers * B
        # cross attention (scores+values) per decoder token
        encoder += (2 * q_toks * d * (H + KV * 0) * Dh
                    + 2 * 2 * q_toks * H * Dh * Se) * cfg.n_layers * B

    fwd = body + attn_sv + logits + encoder
    if kind == "train":
        mult = 4.0 if remat else 3.0   # fwd + 2x bwd (+1x remat recompute)
        total = fwd * mult
    else:
        total = fwd
    return {
        "forward_flops": fwd,
        "total_flops": total,
        "attention_flops": attn_sv,
        "logits_flops": logits,
    }


def cell_hbm_bytes(cfg: ModelConfig, shape: ShapeCell, microbatches: int,
                   param_bytes: int = 4) -> Dict[str, float]:
    """Coarse global HBM traffic model for one step (documented lower
    bound: weights + cache + logits + residual activations; ignores
    fused intermediates which HLO 'bytes accessed' overcounts)."""
    S, B = shape.seq_len, shape.global_batch
    kind = shape.kind
    n_params = cfg.param_count()

    if kind == "train":
        # per microbatch: fwd read + remat read + bwd read; grads written
        # once per mb; optimizer reads m,v + params, writes all three.
        weight_traffic = n_params * param_bytes * (3 * microbatches + 6)
        act = B * S * cfg.d_model * 2 * cfg.n_layers * 3   # bf16 carries
        logits = B * S * cfg.padded_vocab * 4 * 2
        cache = 0.0
    else:
        weight_traffic = n_params * 2  # bf16 serve, one read
        act = B * (1 if kind == "decode" else S) * cfg.d_model * 2 * cfg.n_layers * 2
        logits = B * (1 if kind == "decode" else S) * cfg.padded_vocab * 2
        cache = 0.0
        if cfg.family != "ssm":
            KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
            for w in cfg.layer_kinds():
                slots = min(w, S) if w else S
                # read (decode) / write (prefill), once
                cache += B * slots * KV * Dh * 2 * 2
        if cfg.family in ("ssm", "hybrid"):
            cache += (B * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
                      * 4 * 2 * cfg.n_layers)
    return {
        "weight_bytes": float(weight_traffic),
        "activation_bytes": float(act),
        "logits_bytes": float(logits),
        "cache_bytes": float(cache),
        "total_bytes": float(weight_traffic + act + logits + cache),
    }
