"""Port parity: ``repro_torch.sharding`` (rules, ``resolve_spec``,
``param_specs``, ``activation_sharding`` / ``constrain``) and
``launch/mesh.py`` against the reference's ``repro.sharding`` and
``jax.sharding``, exactly.

The four rule tables and ``is_axes_leaf``; ``resolve_spec`` as tuples on
every logical axes tuple of every arch's param, input and decode-cache
axes trees (the port's, from ``api.abstract()`` on the meta device)
under each table, on the single-pod, multi-pod and one-card meshes'
axis names; per-leaf shard shapes against
``NamedSharding(AbstractMesh(sizes, names), spec).shard_shape`` wherever
the division is even (``AbstractMesh`` raises elsewhere; the ceil rule has
its own test); ``constrain`` against the reference's under ``jax.jit`` on
a one-device mesh."""

import threading
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.sharding import activation as jact
from repro.sharding import rules as jrules
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm as tlm
from repro_torch.models.config import SHAPES
from repro_torch.sharding import activation as tact
from repro_torch.sharding import rules as trules
from test_torch_lm_train import one_torch_thread  # noqa: F401

ARCHS = jconfigs.list_archs()
TABLES = ["TRAIN_RULES", "SERVE_RULES", "LONG_CONTEXT_SERVE_RULES",
          "DECODE_SP_RULES"]
MESHES = {"single": tmesh.make_production_mesh(),
          "multi": tmesh.make_production_mesh(multi_pod=True),
          "card": tmesh.make_card_mesh()}


class FakeMesh:
    def __init__(self, names):
        self.axis_names = names


class Pair(NamedTuple):
    a: tuple
    b: tuple


_APIS = {}


def _trees(arch, caches=((4, 64),)):
    """The port's (values, axes) pairs of the arch's params, the
    prefill_32k batch and the decode caches at each (B, S) of
    ``caches``; the API and its param tree built once per arch."""
    if arch not in _APIS:
        api = tlm.build(tconfigs.get(arch), device="cpu")
        _APIS[arch] = (api, api.abstract())
    api, params = _APIS[arch]
    batch = api.input_specs(SHAPES["prefill_32k"])
    return [params, (batch, api.input_axes())] + [
        (api.decode_cache_specs(B, S), api.decode_cache_axes(B, S))
        for B, S in caches]


def _axes_leaves(tree):
    out = []
    trules.tree_map(out.append, tree)
    return out


def test_rule_tables_equal_the_reference():
    for name in TABLES:
        assert getattr(trules, name) == getattr(jrules, name), name


def test_is_axes_leaf_equals_the_reference():
    cases = [(), ("batch", None), (None,), ("a", 1), ("x", ("y",)),
             Pair(("a",), ("b",)), ["batch"], "batch", None,
             (None, None, "heads"), (("pod", "data"), None)]
    for c in cases:
        assert trules.is_axes_leaf(c) == jrules.is_axes_leaf(c), c
    assert trules.is_axes_leaf(trules.Axes(("a", None)))
    assert jrules.is_axes_leaf(jrules.Axes(("a", None)))


@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_spec_equals_the_reference(arch):
    """Every axes tuple of the arch's trees x the four tables x the three
    meshes' axis names; ``param_specs`` maps the same specs over the
    param tree."""
    seen = {tuple(a) for _, axes in _trees(arch) for a in _axes_leaves(axes)}
    assert seen and all(isinstance(a, tuple) for a in seen)
    for table in TABLES:
        jr, tr = getattr(jrules, table), getattr(trules, table)
        for m in MESHES.values():
            fake = FakeMesh(m.axis_names)
            for axes in seen:
                got = trules.resolve_spec(axes, tr, fake)
                assert isinstance(got, trules.PartitionSpec)
                assert tuple(got) == tuple(jrules.resolve_spec(axes, jr,
                                                               fake))
    _, axes = _trees(arch)[0]
    specs = trules.param_specs(axes, trules.TRAIN_RULES, MESHES["single"])
    assert _axes_leaves(specs) == [
        trules.resolve_spec(a, trules.TRAIN_RULES, MESHES["single"])
        for a in _axes_leaves(axes)]


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shapes_equal_abstract_mesh(arch):
    """Each tensor's shard shape under each table and mesh against jax's
    ``NamedSharding.shard_shape`` where every dim divides evenly; the
    decode caches at decode_32k's shape and long_500k's."""
    trees = _trees(arch, caches=((128, 32768), (1, 524288)))
    seen = set()
    for name, m in MESHES.items():
        amesh = AbstractMesh(m.sizes, m.axis_names)
        for table in TABLES:
            rules = getattr(trules, table)
            for values, axes in trees:
                specs = trules.param_specs(axes, rules, m)
                trules.tree_map(lambda s, t: seen.add(
                    (name, tuple(s), tuple(t.shape))), specs, values,
                    is_leaf=lambda x: isinstance(x, trules.PartitionSpec))
    compared = 0
    for name, spec, shape in seen:      # each (mesh, spec, shape) once
        m = MESHES[name]
        got = tmesh.shard_shape(shape, trules.PartitionSpec(*spec), m)
        factors = [int(np.prod([m.shape[a] for a in (
            (e,) if isinstance(e, str) else (e or ()))])) for e in spec]
        if any(d % f for d, f in zip(shape, factors)):
            continue
        want = NamedSharding(AbstractMesh(m.sizes, m.axis_names),
                             JP(*spec)).shard_shape(shape)
        assert got == tuple(want), (name, spec, shape)
        compared += 1
    assert compared > 0


def test_shard_shape_rounds_uneven_shards_up():
    m = tmesh.make_test_mesh((4, 2, 3), ("pod", "data", "model"))
    P = trules.PartitionSpec
    assert tmesh.shard_shape((10, 7), P("pod", None), m) == (3, 7)
    assert tmesh.shard_shape((10, 7), P(("pod", "data")), m) == (2, 7)
    assert tmesh.shard_shape((10, 7, 5), P(None, "model"), m) == (10, 3, 5)
    assert tmesh.shard_shape((8, 6), P("pod", "model"), m) == (2, 2)
    assert tmesh.shard_shape((), P(), m) == ()
    with pytest.raises(ValueError):
        NamedSharding(AbstractMesh(m.sizes, m.axis_names),
                      JP("pod", None)).shard_shape((10, 7))
    t = torch.empty((10, 7), dtype=torch.bfloat16, device="meta")
    assert tmesh.tree_bytes({"x": [t]}, {"x": [P("pod", None)]}, m) == (
        3 * 7 * 2)


def test_meshes():
    single, multi, card = MESHES["single"], MESHES["multi"], MESHES["card"]
    assert list(single.shape.items()) == [("data", 16), ("model", 16)]
    assert list(multi.shape.items()) == [("pod", 2), ("data", 16),
                                         ("model", 16)]
    assert (single.size, multi.size, card.size) == (256, 512, 1)
    assert card.axis_names == ("data", "model") and card.sizes == (1, 1)
    test = tmesh.make_test_mesh()
    assert (test.sizes, test.axis_names) == ((2, 2), ("data", "model"))
    with pytest.raises(ValueError):
        tmesh.make_test_mesh((2, 2), ("data",))


def _jax_constrain(rules, axes, x):
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    with jact.activation_sharding(rules, mesh):
        return jax.jit(lambda v: jact.constrain(v, axes))(x)


def _outcome(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 — the error's kind is compared
        return type(e)


@pytest.mark.parametrize("axes", [("batch", "seq"), ("nonexistent", None),
                                  ("batch", "seq", "embed_act"), ()],
                         ids=["known", "unknown-name", "longer", "empty"])
def test_constrain_fails_where_the_reference_does(axes):
    x = np.ones((4, 6), np.float32)
    t = torch.from_numpy(x)
    assert tact.constrain(t, axes) is t          # outside any context
    mesh = tmesh.make_card_mesh()
    for rules in ("TRAIN_RULES", None):
        want = _outcome(lambda: _jax_constrain(
            getattr(jrules, rules) if rules else None, axes, jnp.asarray(x)))
        with tact.activation_sharding(
                getattr(trules, rules) if rules else None, mesh):
            got = _outcome(lambda: tact.constrain(t, axes))
            if got is None:
                assert tact.constrain(t, axes) is t
        assert got == want, (rules, axes)


def test_activation_sharding_nests_and_stays_in_its_thread():
    mesh = tmesh.make_card_mesh()
    t = torch.ones(2, 3)
    seen = []
    with tact.activation_sharding(trules.TRAIN_RULES, mesh):
        with tact.activation_sharding(None, mesh):
            with pytest.raises(AttributeError):
                tact.constrain(t, ("batch",))
        assert tact.constrain(t, ("batch",)) is t
        th = threading.Thread(target=lambda: seen.append(
            tact.constrain(t, ("a", "b", "c", "d"))))
        th.start()
        th.join(timeout=30)
    assert not th.is_alive() and seen == [t]
    assert tact._top() is None
