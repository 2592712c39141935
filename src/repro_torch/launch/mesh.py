"""Logical meshes (``repro.launch.mesh``), touching no device.

The reference builds ``jax.sharding.Mesh`` objects over forced host
devices.  The port runs on one card, so a mesh here is its shape and axis
names only: enough for ``sharding.rules.resolve_spec`` and for per-device
shard shapes (``shard_shape``), which is what the dry-run records read.

Mesh shapes:
  single-pod : (16, 16)        axes (data, model)   = 256 chips
  multi-pod  : (2, 16, 16)     axes (pod, data, model) = 512 chips
  card       : (1, 1)          axes (data, model)   = the one H100

Axis roles: ``data`` = DP + ZeRO/FSDP (+ sequence parallelism for the
long-context serve cells); ``model`` = TP/EP; ``pod`` = cross-pod DP.
``Step`` is a cell's step function on the card with the reference's
``in_shardings`` / ``out_shardings`` as spec trees.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

from ..sharding.rules import PartitionSpec, tree_map


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.sizes} does not match axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in order (``jax.sharding.Mesh.shape``)."""
        return collections.OrderedDict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    if multi_pod:
        return LogicalMesh((2, 16, 16), ("pod", "data", "model"))
    return LogicalMesh((16, 16), ("data", "model"))


def make_test_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model")) -> LogicalMesh:
    return LogicalMesh(tuple(shape), tuple(axes))


def make_card_mesh() -> LogicalMesh:
    """The one H100 as a (1, 1) ("data", "model") mesh: every spec
    resolves as on a pod, and every shard is the whole array."""
    return LogicalMesh((1, 1), ("data", "model"))


def shard_shape(shape: Sequence[int], spec, mesh: LogicalMesh) -> tuple:
    """The per-device shape of an array of ``shape`` laid out by ``spec``
    on ``mesh``: each dim divided by the product of its mesh axes' sizes,
    rounded up (an uneven last shard is padded to the others' size)."""
    sizes = mesh.shape
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        names = (entry,) if isinstance(entry, str) else (entry or ())
        out.append(-(-dim // math.prod(sizes[a] for a in names)))
    return tuple(out)


def tree_bytes(tree, specs, mesh: LogicalMesh) -> int:
    """Per-device bytes of the tensors of ``tree`` laid out by the spec
    tree ``specs`` (the same structure, a ``PartitionSpec`` at each
    tensor) on ``mesh``."""
    total = []
    tree_map(lambda spec, t: total.append(
        math.prod(shard_shape(t.shape, spec, mesh)) * t.element_size()),
        specs, tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return sum(total)


@dataclasses.dataclass(frozen=True)
class Step:
    """A cell's step: ``fn`` runs eagerly on the arguments' device;
    ``in_specs`` are the reference's ``in_shardings`` as spec trees over
    the arguments.  Where the reference fixes ``out_shardings``,
    ``out_specs`` holds them and ``outs`` the outputs on the meta device."""
    fn: Callable
    in_specs: tuple
    out_specs: Optional[tuple] = None
    outs: Optional[tuple] = None

    def __call__(self, *args):
        return self.fn(*args)
