"""Activation sharding constraints (``repro.sharding.activation``) on one
card: ``constrain`` returns its input.  The model code calls it at the
reference's cut points, so a mesh can take them over later."""
from __future__ import annotations

from typing import Optional, Tuple


def constrain(x, axes: Tuple[Optional[str], ...]):
    """Identity: one card holds every activation whole."""
    del axes
    return x
