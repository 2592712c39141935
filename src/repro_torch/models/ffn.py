"""Feed-forward layers (``repro.models.ffn``): the gated dense FFN and the
GShard-style capacity-routed MoE.

MoE, as in the reference: tokens are routed in groups of
``moe_group_size`` with a capacity per group; top-k ranks claim capacity
slots in priority order (rank 0 first), and a choice past the capacity is
dropped (its combine weight is zero).  Dispatch and combine are einsums
against (G, S_g, E, C) masks, every expert computed on its C slots.

The router's float32 softmax is XLA's CPU softmax op for op
(``softmax_f32``: ``prng.xla_exp``, the max-shifted sum in XLA's order,
an IEEE divide), and its top-k a stable descending sort (``top_k``: the lower
expert index first on a tie, as ``jax.lax.top_k``), so ``_route``'s
dispatch and combine equal the reference's bit for bit on the same logits,
and the card's equal the CPU's.  Its backward is softmax's rule, as
``jax.nn.softmax``'s custom JVP, not the derivative of the exp polynomial.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .. import prng
from ..sharding.activation import constrain
from . import params as pp


def ffn_init(key, d_model, d_ff, gated: bool = True, dtype=torch.float32,
             device=None):
    k1, k2, k3 = prng.split(key, 3)
    out = {
        "wi_gate": pp.dense_init(k1, (d_model, d_ff), ("d_model", "d_ff"),
                                 dtype=dtype, device=device),
        "wo": pp.dense_init(k3, (d_ff, d_model), ("d_ff", "d_model"),
                            dtype=dtype, device=device),
    }
    if gated:
        out["wi_up"] = pp.dense_init(k2, (d_model, d_ff), ("d_model", "d_ff"),
                                     dtype=dtype, device=device)
    return out


def _act(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind in ("geglu", "gelu"):          # gelu's tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def ffn_apply(p: Dict, x, act: str = "silu"):
    p = pp.cast_tree(p, x.dtype)
    h = _act(x @ p["wi_gate"], act)
    h = constrain(h, ("batch", "seq", "d_ff_act"))
    if "wi_up" in p:  # gated variant
        h = h * (x @ p["wi_up"])
    return h @ p["wo"]


# ------------------------------------------------------------------------ MoE
SUM_WINDOW = 32                           # XLA's CPU reduce window


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in the order of XLA's CPU reduce:
    left to right within windows of ``SUM_WINDOW`` (the last one padded
    with zeros), then the same over the windows' sums.  XLA's order for a
    width up to 32 or a multiple of 32 (every config's expert count)."""
    n = x.shape[-1]
    if n <= SUM_WINDOW:
        return _left_sum(x)
    x = F.pad(x, (0, -n % SUM_WINDOW))
    return xla_sum(_left_sum(x.reshape(*x.shape[:-1], -1, SUM_WINDOW)))


def _left_sum(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


class _Softmax(torch.autograd.Function):
    """XLA's float32 softmax forward; the backward of ``jax.nn.softmax``'s
    custom JVP, y * (g - sum(y * g)), not autograd through ``xla_exp``'s
    polynomial."""

    @staticmethod
    def forward(ctx, x):
        u = prng.xla_exp(x - x.amax(dim=-1, keepdim=True))
        y = u / xla_sum(u)[..., None]
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return y * (g - torch.sum(y * g, dim=-1, keepdim=True))


def softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis in float32, op for op as XLA's
    CPU runs it: exp(x - max) / sum; differentiated by softmax's own rule,
    as the reference's custom JVP is."""
    return _Softmax.apply(logits.float())


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, the lower
    index first among equal values (``jax.lax.top_k``'s order; a stable
    sort, where ``torch.topk`` promises no order on a tie)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_init(key, cfg, dtype=torch.float32, device=None):
    """Router + stacked expert weights (+ optional shared experts), drawn
    as the reference's and stored in ``dtype``."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    ks = prng.split(key, 5)
    kw = dict(dtype=dtype, device=device)
    out = {
        "router": pp.dense_init(ks[0], (d, E), ("d_model", None), **kw),
        "wi_gate": pp.dense_init(ks[1], (E, d, f),
                                 ("experts", "d_model", "d_ff"), **kw),
        "wi_up": pp.dense_init(ks[2], (E, d, f),
                               ("experts", "d_model", "d_ff"), **kw),
        "wo": pp.dense_init(ks[3], (E, f, d), ("experts", "d_ff", "d_model"),
                            **kw),
    }
    if cfg.n_shared_experts:
        out["shared"] = ffn_init(ks[4], d, cfg.n_shared_experts * f, **kw)
    return out


def _route(logits, k: int, capacity: int):
    """logits (G, S, E) -> dispatch (G,S,E,C) f32, combine (G,S,E,C) f32.

    Priority dispatch: rank-0 choices claim capacity slots before rank-1,
    etc.  Over-capacity (slot >= C) choices are dropped.  The reference
    loops over the ranks; here every rank's slots come at once (a choice's
    slot counts the same rank's earlier tokens and every earlier rank's
    claims) and one scatter places them: a token's k experts differ, so
    no two choices of a token share a cell, and the masks are the
    reference's bit for bit.
    """
    G, S, E = logits.shape
    probs = softmax_f32(logits)
    gate_vals, gate_idx = top_k(probs, k)                   # (G, S, k)
    onehot = F.one_hot(gate_idx, E).to(torch.int32)         # (G, S, k, E)
    totals = onehot.sum(dim=1, dtype=torch.int32)           # (G, k, E)
    earlier = torch.cumsum(totals, dim=1, dtype=torch.int32) - totals
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot \
        + earlier[:, None]
    slot = (pos * onehot).sum(dim=-1)                       # (G, S, k)
    keep = (slot < capacity).float()
    # a dropped choice writes its 0 into its own expert's last slot
    cell = gate_idx * capacity + torch.clamp(slot, max=capacity - 1)
    dispatch = torch.zeros((G, S, E * capacity), device=logits.device)
    combine = torch.zeros((G, S, E * capacity), device=logits.device)
    dispatch.scatter_(2, cell, keep)
    combine.scatter_(2, cell, keep * gate_vals)
    return (dispatch.view(G, S, E, capacity),
            combine.view(G, S, E, capacity))


def capacity_of(cfg, gs: int) -> int:
    """Slots per expert in a group of ``gs`` tokens (Python floats, as the
    reference)."""
    return max(1, int(gs * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def moe_apply(p: Dict, x, cfg, act: str = "silu"):
    """x (B, S, D) -> (B, S, D).  Capacity-routed top-k experts + shared.
    Groups of min(moe_group_size, S) tokens, which must divide B * S (the
    reference's assertion)."""
    p = pp.cast_tree(p, x.dtype)
    B, S, D = x.shape
    gs = min(cfg.moe_group_size, S)
    if (B * S) % gs:
        raise ValueError(f"moe_apply: {B} x {S} tokens are not groups of "
                         f"{gs} (the reference asserts (B * S) % gs == 0)")
    G = B * S // gs
    xg = x.reshape(G, gs, D)
    logits = xg @ p["router"]                               # (G, gs, E)
    dispatch, combine = _route(logits, cfg.top_k, capacity_of(cfg, gs))
    # dispatch: (G,gs,E,C) x (G,gs,D) -> (G,E,C,D)
    buf = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    del dispatch
    h = _act(torch.einsum("gecd,edf->gecf", buf, p["wi_gate"]), act)
    h = h * torch.einsum("gecd,edf->gecf", buf, p["wi_up"])
    eo = torch.einsum("gecf,efd->gecd", h, p["wo"])
    out = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), eo)
    out = out.reshape(B, S, D)
    if "shared" in p:
        out = out + ffn_apply(p["shared"], x, act)
    return out


def moe_aux_loss(logits, k: int):
    """Load-balancing auxiliary loss (Switch-style): E * sum(f_e * p_e)."""
    E = logits.shape[-1]
    probs = softmax_f32(logits)
    _, idx = top_k(probs, k)
    f = torch.mean(F.one_hot(idx, E).float(), dim=(0, 1, 2))
    pbar = torch.mean(probs, dim=tuple(range(probs.ndim - 1)))
    return E * torch.sum(f * pbar)
