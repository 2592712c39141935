"""Logical sharding axes on one card (``repro.sharding``, reduced): the
axes stay on the param trees, ``constrain`` is the identity."""
from .activation import constrain  # noqa: F401
from .rules import Axes  # noqa: F401
