"""Activation sharding constraints (``repro.sharding.activation``),
decoupled from model code.

Model forward passes call ``constrain(x, ("batch", "seq", "embed_act"))``
at the reference's cut points.  Outside any context this is the identity;
inside ``activation_sharding(rules, mesh)`` it resolves the axes against
the rules and the mesh, so a rule table or mesh the model cannot take
fails here as it does in the reference, and then returns ``x`` unchanged:
one card holds every activation whole, so there is no constraint to lay.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

from . import rules as rules_lib

_state = threading.local()


def _top():
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def activation_sharding(rules: rules_lib.Rules, mesh):
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append((rules, mesh))
    try:
        yield
    finally:
        stack.pop()


def constrain(x, axes: Tuple[Optional[str], ...]):
    """``x`` itself.  Inside a context, ``axes`` must resolve against its
    rules and mesh, and name no more dims than ``x`` has (the reference's
    ``with_sharding_constraint`` raises for a longer spec)."""
    ctx = _top()
    if ctx is None:
        return x
    rules, mesh = ctx
    spec = rules_lib.resolve_spec(axes, rules, mesh)
    if len(spec) > x.ndim:
        raise ValueError(f"{spec} is only valid for values of rank at least "
                         f"{len(spec)}, but got a value of rank {x.ndim}")
    return x
