"""Logical sharding (``repro.sharding``): the rule tables, ``resolve_spec``
and ``param_specs`` over logical meshes, and activation constraints, which
one card resolves and leaves as the identity."""
from .activation import activation_sharding, constrain  # noqa: F401
from .rules import (  # noqa: F401
    DECODE_SP_RULES, LONG_CONTEXT_SERVE_RULES, SERVE_RULES, TRAIN_RULES,
    Axes, PartitionSpec, Rules, param_specs, resolve_spec,
)
