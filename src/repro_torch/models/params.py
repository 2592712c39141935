"""Annotated parameters (``repro.models.params``): every leaf carries its
logical sharding axes.

Init functions build trees whose leaves are ``P(value, axes)``; ``split``
separates them into a value tree and an axes tree.  Draws go through
``repro_torch.prng``, the reference's ``jax.random``, in float32, so a
key gives the reference's values; ``dtype`` is what the value is stored
in (the float32 draw times its scale, cast once).

Logical axis names: "vocab" "d_model" "d_ff" "heads" "kv_heads"
"head_dim" "experts" "ssm_inner" "ssm_state" "layers" None.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import prng
from ..device import resolve_device


class P(NamedTuple):
    value: Any
    axes: Tuple[Optional[str], ...]


def is_p(x) -> bool:
    return isinstance(x, P)


def tree_map(fn, tree, is_leaf=None):
    """``fn`` over the leaves of a tree of dicts and lists (NamedTuples
    and ``is_leaf`` matches are leaves), keeping its structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, is_leaf) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def split(tree):
    values = tree_map(lambda p: p.value, tree, is_p)
    axes = tree_map(lambda p: p.axes, tree, is_p)
    return values, axes


def stack_layers(init_fn, keys):
    """(values, axes) of the P trees ``init_fn(key)`` for each of ``keys``,
    stacked on a leading "layers" dim, as the reference stacks them.  Each
    layer is drawn and copied into the stacked tensors in turn, so the init
    holds one layer beyond the stack."""
    stacked = axes = None
    for l, key in enumerate(keys):
        vals, axes = split(init_fn(key))
        if stacked is None:
            stacked = tree_map(lambda v: v.new_empty((len(keys),)
                                                     + tuple(v.shape)), vals)
        for s, v in zip(tree_leaves(stacked), tree_leaves(vals)):
            s[l].copy_(v)
        del vals
    axes = tree_map(lambda a: ("layers",) + a, axes,
                    is_leaf=lambda x: isinstance(x, tuple))
    return stacked, axes


def dense_init(key, shape, axes, scale: float = 1.0, dtype=torch.float32,
               device=None) -> P:
    """normal(key, shape) * scale / sqrt(fan_in), fan_in = shape[-2]."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    out = torch.empty(tuple(shape), dtype=dtype, device=resolve_device(device))
    return P(prng.normal_into(out, key, scale / np.sqrt(fan_in)), axes)


def embed_init(key, vocab, d_model, dtype=torch.float32, device=None) -> P:
    out = torch.empty((vocab, d_model), dtype=dtype,
                      device=resolve_device(device))
    return P(prng.normal_into(out, key, 0.02), ("vocab", "d_model"))


def zeros_init(shape, axes, dtype=torch.float32, device=None) -> P:
    return P(torch.zeros(tuple(shape), dtype=dtype,
                         device=resolve_device(device)), axes)


def ones_init(shape, axes, dtype=torch.float32, device=None) -> P:
    return P(torch.ones(tuple(shape), dtype=dtype,
                        device=resolve_device(device)), axes)


def rms_norm(x, weight, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) * (1 + weight), in float32, back in x's
    dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


def cast_tree(tree, dtype):
    """Float leaves to the compute dtype (the reference's mixed-precision
    entry point); a no-op for weights already stored in it."""
    return tree_map(lambda w: w.to(dtype) if torch.is_floating_point(w)
                    else w, tree)


def softcap(x, cap: float):
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
