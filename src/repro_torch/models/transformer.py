"""The decoder-only transformer (``repro.models.transformer``): the dense,
MoE, SSM (Mamba-2), hybrid (parallel attention + SSM) and prefix-VLM
families.

One layer body, eager: layers run in a Python loop (the reference scans
them), each with its own window from ``cfg.layer_kinds()``, so gemma2's
alternating and gemma3's 5:1 local:global patterns need no traced window.
Params are stacked over layers (a leading "layers" dim), as the
reference's ``model_init`` builds them; a layer is the slice ``[l]``.

Prefill self-attention (no ``extra_mask``) goes through ``attend``, the
attention function the model was built with (``lm.build``): the flash
kernel by default, its plain version by request.
Decode attends over the caches with ``attention.decode_attend``, as the
reference does.

The SSM family has no attention: each layer's SSD block hands its state
(final h, conv tail) to decode.  The hybrid family runs attention and SSD
in parallel on the same normed input and averages their normed outputs.
The MoE family's FFN is ``ffn.moe_apply``.  The VLM (paligemma) prepends
``img_embeds`` (B, prefix_tokens, d_model) to the embedded text and
passes the prefix mask (bidirectional over the image prefix, OR'd into
the causal mask) to every layer as ``extra_mask``, so its prefill
attention goes through ``attend_chunked``, as the reference's does; its
caches hold the prefix's K/V and decode positions run on after it.  The
encoder-decoder is ``models/encdec.py`` (``lm.build`` dispatches it
there); the functions here refuse it (``require_decoder``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from .. import prng
from ..sharding.activation import constrain
from . import attention as attn
from . import ffn as ffn_lib
from . import params as pp
from . import ssm as ssm_lib
from .config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def require_decoder(cfg: ModelConfig) -> None:
    """Raise for a family this decoder-only stack does not build: the
    encoder-decoder is ``models/encdec.py``."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is no "
                         f"decoder-only transformer (the encoder-decoder is "
                         f"models/encdec.py)")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


REMAT_POLICIES = (None, "full", "dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, policy: Optional[str]) -> Callable:
    """``fn`` under the reference's ``jax.checkpoint`` policy while autograd
    records: "full" keeps only the layer's inputs and recomputes the rest
    in backward, "dots" keeps the matmul outputs (``checkpoint_dots``),
    None keeps everything.  Values and gradients do not depend on it."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r}: one of {REMAT_POLICIES}")
    if policy is None or not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _save_dots)

    def wrapped(*args):
        if not any(t.requires_grad for t in pp.tree_leaves(list(args))
                   if isinstance(t, torch.Tensor)):
            return fn(*args)          # nothing to differentiate
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


# ------------------------------------------------------------------ layer init
def _attn_init(key, cfg: ModelConfig, dtype, device):
    """Projections stored 2D with combined (heads*head_dim) axes, as the
    reference stores them."""
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    ks = prng.split(key, 4)
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": pp.dense_init(ks[0], (d, H * Dh), ("d_model", "heads"), **kw),
        "wk": pp.dense_init(ks[1], (d, KV * Dh), ("d_model", "kv_heads"), **kw),
        "wv": pp.dense_init(ks[2], (d, KV * Dh), ("d_model", "kv_heads"), **kw),
        "wo": pp.dense_init(ks[3], (H * Dh, d), ("heads", "d_model"), **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = pp.zeros_init((Dh,), (None,), device=device)
        p["k_norm"] = pp.zeros_init((Dh,), (None,), device=device)
    return p


def layer_init(key, cfg: ModelConfig, moe: bool, dtype=torch.float32,
               device=None):
    """One layer's P tree: its matrices drawn in float32 and stored in
    ``dtype``, its norms' scales and the SSM's 1-D leaves in float32 (the
    reference keeps float32 masters and casts at use)."""
    require_decoder(cfg)
    d = cfg.d_model
    ks = prng.split(key, 4)
    norm = lambda: pp.zeros_init((d,), ("d_model",), device=device)  # noqa: E731
    p: Dict[str, Any] = {"pre_attn_norm": norm()}
    if cfg.family != "ssm":
        p["attn"] = _attn_init(ks[0], cfg, dtype, device)
    if cfg.family in ("ssm", "hybrid"):
        p["ssm"] = ssm_lib.ssm_init(ks[1], cfg, dtype, device)
        if cfg.parallel_ssm:
            p["attn_branch_norm"] = norm()
            p["ssm_branch_norm"] = norm()
    if cfg.post_norms:
        p["post_attn_norm"] = norm()
    if cfg.family != "ssm" and cfg.d_ff > 0:
        p["pre_ffn_norm"] = norm()
        if moe:
            p["moe"] = ffn_lib.moe_init(ks[2], cfg, dtype, device)
        else:
            p["ffn"] = ffn_lib.ffn_init(ks[2], d, cfg.d_ff, dtype=dtype,
                                        device=device)
        if cfg.post_norms:
            p["post_ffn_norm"] = norm()
    return p


def model_init(key, cfg: ModelConfig, dtype=torch.float32, device=None):
    """Returns (values, axes): stacked-layer params, the reference's for
    the same key.  Matrices are stored in ``dtype`` (float32, the
    reference's master weights, by default), each drawn in float32 and
    cast once; layers are drawn one at a time into the stacked tensors, so
    the init holds one layer beyond the model.  On the meta device nothing
    is drawn (``abstract``)."""
    require_decoder(cfg)
    ks = prng.split(key, cfg.n_layers + 3)
    tree: Dict[str, Any] = {
        "embed": pp.embed_init(ks[0], cfg.padded_vocab, cfg.d_model,
                               dtype=dtype, device=device),
        "final_norm": pp.zeros_init((cfg.d_model,), ("d_model",),
                                    device=device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = pp.dense_init(
            ks[1], (cfg.d_model, cfg.padded_vocab), ("d_model", "vocab"),
            dtype=dtype, device=device)
    stacked, stacked_axes = pp.stack_layers(
        lambda k: layer_init(k, cfg, moe=cfg.family == "moe", dtype=dtype,
                             device=device), ks[3:3 + cfg.n_layers])
    top_vals, top_axes = pp.split(tree)
    return ({**top_vals, "layers": stacked},
            {**top_axes, "layers": stacked_axes})


# --------------------------------------------------------------- layer forward
def _attention_block(p, x, cfg: ModelConfig, window: int, positions,
                     attend: Callable, extra_mask=None, chunk: int = 1024):
    """x (B,S,D) -> (attention output (B,S,D), (k, v)).  Self-attention
    without ``extra_mask`` goes through ``attend(q, k, v, window,
    softcap)``; with one (which the kernel does not take) through
    ``attend_chunked``."""
    B, S, _ = x.shape
    H, Dh, KV = cfg.n_heads, cfg.resolved_head_dim, cfg.n_kv_heads
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, Dh)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, KV, Dh)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, KV, Dh)
    if cfg.qk_norm:
        q = pp.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = pp.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = attn.apply_rope(q, positions[None], cfg.rope_theta)
    k = attn.apply_rope(k, positions[None], cfg.rope_theta)
    q = constrain(q, ("batch", "seq", "heads_act", None))
    k = constrain(k, ("batch", "seq", "heads_act", None))
    if extra_mask is None:
        out = attend(q, k, v, window, cfg.attn_softcap)
    else:
        out = attn.attend_chunked(q, k, v, positions, positions, window,
                                  cfg.attn_softcap, min(chunk, S), extra_mask)
    out = out.reshape(B, S, H * Dh) @ p["wo"].to(x.dtype)
    return out, (k, v)


def _ffn_block(p, x, cfg: ModelConfig):
    h2 = pp.rms_norm(x, p["pre_ffn_norm"], cfg.norm_eps)
    if "moe" in p:
        f = ffn_lib.moe_apply(p["moe"], h2, cfg, cfg.act)
    else:
        f = ffn_lib.ffn_apply(p["ffn"], h2, cfg.act)
    if cfg.post_norms:
        f = pp.rms_norm(f, p["post_ffn_norm"], cfg.norm_eps)
    return x + f


def _parallel_branches(p, a_out, s_out, cfg: ModelConfig):
    """Hybrid: the mean of the normed attention and SSM outputs."""
    return 0.5 * (pp.rms_norm(a_out, p["attn_branch_norm"], cfg.norm_eps)
                  + pp.rms_norm(s_out, p["ssm_branch_norm"], cfg.norm_eps))


def layer_apply(p, x, cfg: ModelConfig, window: int, positions,
                attend: Callable, extra_mask=None, collect_kv: bool = False):
    """One layer.  Returns (x, (kv or None, ssm_state or None)): the cache
    material only when ``collect_kv`` (prefill)."""
    kv = ssm_state = None
    h = pp.rms_norm(x, p["pre_attn_norm"], cfg.norm_eps)
    if cfg.family == "ssm":
        s_out, ssm_state = ssm_lib.ssm_apply_with_state(p["ssm"], h, cfg)
        x = x + s_out
    else:
        a_out, kv = _attention_block(p["attn"], h, cfg, window, positions,
                                     attend, extra_mask=extra_mask)
        if cfg.parallel_ssm:
            s_out, ssm_state = ssm_lib.ssm_apply_with_state(p["ssm"], h, cfg)
            a_out = _parallel_branches(p, a_out, s_out, cfg)
        if cfg.post_norms:
            a_out = pp.rms_norm(a_out, p["post_attn_norm"], cfg.norm_eps)
        x = x + a_out
        if cfg.d_ff > 0:
            x = _ffn_block(p, x, cfg)
    x = constrain(x, ("batch", "seq", "embed_act"))
    if not collect_kv:
        kv, ssm_state = None, None
    return x, (kv, ssm_state)


# -------------------------------------------------------------------- forward
def embed_tokens(values, cfg: ModelConfig, tokens):
    """The embedding rows (times sqrt(d_model) in float32 for the gemma
    family), in the compute dtype.  With float32 rows this is the
    reference's arithmetic; rows stored in bf16 are rounded once before
    the scale (the reference scales its float32 master rows)."""
    x = values["embed"][tokens]
    if cfg.embed_scale:
        x = x.float() * float(torch.tensor(math.sqrt(cfg.d_model),
                                           dtype=torch.float32))
    return x.to(compute_dtype(cfg))


def unembed(values, cfg: ModelConfig, x):
    """Final norm, the (tied) head in the compute dtype, logits in float32
    softcapped in place, vocab padding masked to -1e30."""
    x = pp.rms_norm(x, values["final_norm"], cfg.norm_eps)
    head = values.get("lm_head")
    if head is None:
        head = values["embed"].T
    logits = torch.matmul(x, head.to(x.dtype)).float()
    if cfg.final_softcap and logits.requires_grad:
        logits = pp.softcap(logits, cfg.final_softcap)
    elif cfg.final_softcap:  # softcap's ops, in place: the logits are fresh
        logits.div_(cfg.final_softcap).tanh_().mul_(cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab:
        logits[..., cfg.vocab:] = -1e30
    return constrain(logits, ("batch", "seq", "vocab_act"))


def layer_slice(values, l: int):
    return pp.tree_map(lambda v: v[l], values["layers"])


def _prefix_mask(prefix_len: int, S: int, device):
    """Bidirectional over the image prefix (paligemma), causal elsewhere:
    bool (S, S) OR'd into the causal mask; None without a prefix."""
    if not prefix_len:
        return None
    i = torch.arange(S, device=device)
    return (i[:, None] < prefix_len) & (i[None, :] < prefix_len)


def forward(values, cfg: ModelConfig, tokens, attend: Callable,
            img_embeds=None, remat_policy: Optional[str] = None,
            collect_kv: bool = False):
    """Train/prefill forward over tokens (B, S_text), with ``img_embeds``
    (B, prefix_tokens, D) prepended where the config has a prefix.
    Returns (logits over the prefix and the text, kvs): kvs a list of each
    layer's ((k, v) or None, SSM state or None) when ``collect_kv``, else
    None.  ``remat_policy`` wraps each layer as the reference's scan body
    (``remat``): memory in backward only, the values do not depend on
    it."""
    require_decoder(cfg)
    x = embed_tokens(values, cfg, tokens)
    if cfg.prefix_tokens:
        if img_embeds is None:
            raise ValueError(f"{cfg.name}: the image prefix needs "
                             f"img_embeds (B, {cfg.prefix_tokens}, "
                             f"{cfg.d_model})")
        x = torch.cat([img_embeds.to(x.dtype), x], dim=1)
    S = x.shape[1]
    x = constrain(x, ("batch", "seq", "embed_act"))
    positions = torch.arange(S, dtype=torch.int64, device=x.device)
    extra_mask = _prefix_mask(cfg.prefix_tokens, S, x.device)
    kvs = [] if collect_kv else None
    for l, window in enumerate(cfg.layer_kinds()):
        def body(x, p, window=window):
            return layer_apply(p, x, cfg, window, positions, attend,
                               extra_mask=extra_mask, collect_kv=collect_kv)
        x, kv = remat(body, remat_policy)(x, layer_slice(values, l))
        if collect_kv:
            kvs.append(kv)
    return unembed(values, cfg, x), kvs


# ------------------------------------------------------------------- serving
class LayerCache(NamedTuple):
    kv: Optional[attn.KVCache]
    ssm: Optional[ssm_lib.SSMState]


def init_layer_caches(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device=None) -> List[LayerCache]:
    """Per-layer decode caches: rings of ``window`` slots for local layers
    shorter than ``max_seq``, linear caches of ``max_seq`` otherwise (none
    for the SSM family); SSM states for the SSM and hybrid families."""
    require_decoder(cfg)
    KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    caches = []
    for window in cfg.layer_kinds():
        kv = ssm = None
        if cfg.family != "ssm":
            slots = window if window and window < max_seq else max_seq
            kv = attn.init_cache(batch, slots, KV, Dh, dtype, device)
        if cfg.family in ("ssm", "hybrid"):
            ssm = ssm_lib.ssm_init_state(cfg, batch, dtype, device)
        caches.append(LayerCache(kv=kv, ssm=ssm))
    return caches


def decode_step(values, cfg: ModelConfig, caches: List[LayerCache], token,
                pos: int):
    """One decode step: token (B, 1) at position ``pos``.  Returns (logits
    (B, 1, V), caches): each layer's KV cache written in place, its SSM
    state replaced by the stepped one."""
    require_decoder(cfg)
    x = embed_tokens(values, cfg, token)
    x = constrain(x, ("batch", None, "embed_act"))
    B = x.shape[0]
    H, Dh, KV = cfg.n_heads, cfg.resolved_head_dim, cfg.n_kv_heads
    pos_arr = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    new_caches = []
    for l, window in enumerate(cfg.layer_kinds()):
        p = layer_slice(values, l)
        kv, ssm = caches[l]
        h = pp.rms_norm(x, p["pre_attn_norm"], cfg.norm_eps)
        if cfg.family == "ssm":
            out, ssm = ssm_lib.ssm_step(p["ssm"], h, ssm, cfg)
            x = x + out
            new_caches.append(LayerCache(kv=kv, ssm=ssm))
            continue
        pa = p["attn"]
        q = (h @ pa["wq"].to(h.dtype)).reshape(B, 1, H, Dh)
        k = (h @ pa["wk"].to(h.dtype)).reshape(B, 1, KV, Dh)
        v = (h @ pa["wv"].to(h.dtype)).reshape(B, 1, KV, Dh)
        if cfg.qk_norm:
            q = pp.rms_norm(q, pa["q_norm"], cfg.norm_eps)
            k = pp.rms_norm(k, pa["k_norm"], cfg.norm_eps)
        q = attn.apply_rope(q, pos_arr, cfg.rope_theta)
        k = attn.apply_rope(k, pos_arr, cfg.rope_theta)
        ring = attn.is_ring(window, kv.k.shape[1])
        attn.cache_update(kv, k, v, pos, ring)
        a = attn.decode_attend(q, kv, pos, ring, KV, window=window,
                               softcap_val=cfg.attn_softcap)
        a_out = a.reshape(B, 1, H * Dh) @ pa["wo"].to(h.dtype)
        if cfg.parallel_ssm:
            s_out, ssm = ssm_lib.ssm_step(p["ssm"], h, ssm, cfg)
            a_out = _parallel_branches(p, a_out, s_out, cfg)
        if cfg.post_norms:
            a_out = pp.rms_norm(a_out, p["post_attn_norm"], cfg.norm_eps)
        x = x + a_out
        if cfg.d_ff > 0:
            x = _ffn_block(p, x, cfg)
        new_caches.append(LayerCache(kv=kv, ssm=ssm))
    return unembed(values, cfg, x), new_caches


def prefill(values, cfg: ModelConfig, tokens, attend: Callable,
            img_embeds=None, max_seq: Optional[int] = None):
    """Prefill forward: (logits, per-layer caches ready for decode).

    Local layers shorter than the prompt hand their last ``window`` keys
    over in the ring layout (slot s = the latest position with
    pos % W == s); the others are zero-padded out to ``max_seq`` slots so
    decode has room to append; SSM layers hand off their final (h, conv)
    state (``transformer.py:346-383``).  A VLM's caches hold the image
    prefix's K/V first, so its decode positions start after the prefix.
    """
    logits, kvs = forward(values, cfg, tokens, attend, img_embeds=img_embeds,
                          collect_kv=True)
    S = logits.shape[1]
    max_seq = max_seq or S
    caches: List[LayerCache] = []
    for window in cfg.layer_kinds():
        kv_l, ssm_state = kvs.pop(0)    # each layer's K/V freed as it goes
        kv = None
        if kv_l is not None:
            k_l, v_l = kv_l
            k_l = k_l.reshape(k_l.shape[0], S, -1)           # flat storage
            v_l = v_l.reshape(v_l.shape[0], S, -1)
            if window and window < S:
                start = S - window
                kv = attn.KVCache(torch.roll(k_l[:, start:], start % window, 1),
                                  torch.roll(v_l[:, start:], start % window, 1))
            elif max_seq > S:
                pad = (0, 0, 0, max_seq - S)
                kv = attn.KVCache(torch.nn.functional.pad(k_l, pad),
                                  torch.nn.functional.pad(v_l, pad))
            else:
                kv = attn.KVCache(k_l, v_l)
        caches.append(LayerCache(kv=kv, ssm=ssm_state))
    return logits, caches
