"""Feed-forward layers (``repro.models.ffn``): the gated dense FFN.

The reference's capacity-routed MoE (``moe_init``, ``_route``,
``moe_apply``, ``moe_aux_loss``) is not ported yet (ROADMAP.md §1, the LM
side's MoE item); ``transformer`` raises for the MoE family.
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
