"""Logical sharding axes on one card (``repro.sharding.rules``, reduced).

The reference's param trees carry logical axis names (``models/params.py``)
that its rule tables map onto a device mesh.  The port runs on one card, so
no mesh exists: the names stay on the trees (``models.params.split`` and
``lm.ModelAPI``'s ``input_axes`` / ``decode_cache_axes`` return them, as
the reference's do) and nothing resolves them.  The rule tables,
``resolve_spec`` and ``param_specs`` come with the multi-card lane.
"""
from __future__ import annotations


class Axes(tuple):
    """Logical-axes leaf marker: an axes tuple that lives inside a
    NamedTuple container (``KVCache``, ``LayerCache``) and must not be read
    as a container itself."""
