"""Logical-axis -> mesh-axis sharding rules (``repro.sharding.rules``,
MaxText-style).

Params carry logical axis names (``models/params.py``); activations are
constrained through ``sharding/activation.py``.  A ``Rules`` table maps
each logical name to a mesh axis (or tuple of axes, or None = replicated).

Mesh axes: ("pod", "data", "model") multi-pod, ("data", "model")
single-pod; the one card is a (1, 1) ("data", "model") mesh
(``launch/mesh.py``).

TRAIN_RULES — ZeRO-3-style: every param's d_model dim shards over ``data``
(FSDP) while TP dims (vocab/heads/d_ff/experts) shard over ``model``.
Optimizer state inherits param sharding, so Adam moments are fully
sharded.

SERVE_RULES — params replicated over ``data`` (no optimizer, latency wins),
TP dims over ``model``; batch shards over (pod, data).

LONG_CONTEXT_SERVE_RULES — for global_batch < |data| (the long_500k cell):
the KV cache's *sequence* dim shards over (pod, data) (sequence
parallelism).

No mesh exists on one card: ``resolve_spec`` returns this module's
``PartitionSpec`` (a tuple, equal entry for entry to the reference's) and
``param_specs`` a tree of them, which ``launch/dryrun.py`` turns into
per-device shard shapes and bytes.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

Assignment = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, Assignment]


class Axes(tuple):
    """Logical-axes leaf marker: an axes tuple that lives inside a
    NamedTuple container (``KVCache``, ``LayerCache``) and must not be read
    as a container itself."""


class PartitionSpec(tuple):
    """One entry per leading dim: None (replicated), a mesh axis name, or a
    tuple of names; equal as a tuple to ``jax.sharding.PartitionSpec``.
    Dims past the last entry are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def is_axes_leaf(x) -> bool:
    return isinstance(x, Axes) or (
        isinstance(x, tuple) and not hasattr(x, "_fields")
        and all(isinstance(a, (str, type(None))) for a in x)
    )


TRAIN_RULES: Rules = {
    # params
    "vocab": "model",
    "d_model": "data",          # FSDP / ZeRO-3
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "d_ff": "model",
    "experts": "model",
    "ssm_inner": "model",
    "layers": None,
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "embed_act": None,
    "heads_act": "model",
    "d_ff_act": "model",
    "vocab_act": "model",
    "experts_act": "model",
    "groups_act": ("pod", "data"),
}

SERVE_RULES: Rules = {
    **TRAIN_RULES,
    "d_model": None,            # replicate params over data for latency
    # d_ff falls back to `data` when `model` is already claimed by the
    # experts dim: dbrx-132b's 250 GB of expert weights then shard
    # (E/model x d_ff/data) = /256 instead of /16 — without this the
    # serve params alone (16.5 GB bf16/chip) overflow HBM.
    "d_ff": ("model", "data"),
}

LONG_CONTEXT_SERVE_RULES: Rules = {
    **SERVE_RULES,
    "batch": None,              # global_batch < |data|: don't shard batch
    "kv_seq": ("pod", "data"),  # sequence parallelism over the cache
    "groups_act": None,
}

# §Perf hillclimb (decode cells): shard the KV cache's SEQUENCE dim over
# the model axis instead of its heads dim.  Decode attention then runs
# fully local per seq-shard (partial softmax + tiny psums) and GSPMD never
# has to reshard the (B, S, KV*Dh) cache between heads/batch layouts —
# which is what blew decode peak memory up at baseline.
DECODE_SP_RULES: Rules = {
    **SERVE_RULES,
    "kv_seq": "model",
    "heads_act": None,
}


def resolve_spec(axes: Tuple[Optional[str], ...], rules: Rules,
                 mesh) -> PartitionSpec:
    """Map logical axes to a PartitionSpec, dropping mesh axes that don't
    exist (single-pod mesh has no 'pod') and de-duplicating axes that would
    be assigned twice (first dim wins).  ``mesh`` needs ``axis_names``."""
    mesh_axes = set(mesh.axis_names)
    used = set()
    out = []
    for ax in axes:
        assign = rules.get(ax) if ax is not None else None
        if assign is None:
            out.append(None)
            continue
        if isinstance(assign, str):
            assign = (assign,)
        picked = tuple(a for a in assign if a in mesh_axes and a not in used)
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(picked)
    return PartitionSpec(*out)


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable = is_axes_leaf):
    """``fn`` over the leaves of ``tree`` and the same places of ``rest``:
    dicts by key, lists, tuples and NamedTuples by position; None stays
    None, as an empty subtree of ``jax.tree.map``.  A leaf is what
    ``is_leaf`` accepts, or anything that is no container."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [tree_map(fn, *xs, is_leaf=is_leaf) for xs in zip(tree, *rest)]
        return (type(tree)(*kids) if hasattr(tree, "_fields")
                else type(tree)(kids))
    return fn(tree, *rest)


def param_specs(axes_tree, rules: Rules, mesh):
    """Axes tree (from ``models.params.split``) -> tree of PartitionSpecs."""
    return tree_map(lambda axes: resolve_spec(axes, rules, mesh), axes_tree)
