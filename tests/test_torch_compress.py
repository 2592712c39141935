"""Port parity: int8 gradient compression (``repro_torch.optim.compress``)
against the reference's ``repro.optim.compress``.

``int8_compress`` / ``int8_decompress`` equal the reference's exactly
(values, scales, pad, round trip) on numpy-seeded tensors of ragged and
chunk-multiple sizes, a zero tensor and exact rounding ties;
``compressed_psum`` over a world of one equals the reference's under
``shard_map`` on a one-device ``pod`` mesh, and ``ErrorFeedback.apply``
the jitted reference's there within 1 ulp (XLA fuses its
dequantize-and-subtract), over five steps of residual feedback.  The reference's own properties hold
too: a round trip within 1 % of the max, error feedback halving the
bias."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro import optim as jopt
from repro_torch import optim as topt
from test_torch_lm_train import one_torch_thread  # noqa: F401

SHAPES = [(1000,), (4, 256), (3, 5, 7), (1,), (256,)]
# jitted, XLA fuses ``ErrorFeedback.apply``'s dequantize-and-subtract
# chains (one rounding where the ops read two); unjitted, the reference
# equals the port bit for bit.  So the jitted one is held to 1 ulp.
ULP = 2.4e-7


def _x(shape, seed=0, scale=0.01):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_int8_compress_equals_reference(shape):
    x = _x(shape)
    jq, js, jpad = jopt.int8_compress(jnp.asarray(x))
    tq, ts, tpad = topt.int8_compress(torch.from_numpy(x))
    assert tpad == jpad and tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    want = jopt.int8_decompress(jq, js, jpad, shape)
    got = topt.int8_decompress(tq, ts, tpad, shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(np.abs(got.numpy() - x).max() / np.abs(x).max()) < 1e-2


def test_ties_and_zeros_equal_reference():
    """Exact halves round to even, as ``jnp.round``; an all-zero chunk
    takes the 1e-12 floor scale."""
    x = np.zeros(512, np.float32)
    x[0] = 127.0                         # scale 1: the rest are exact
    x[1:8] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    for arr in (x, np.zeros(300, np.float32)):
        jq, js, _ = jopt.int8_compress(jnp.asarray(arr))
        tq, ts, _ = topt.int8_compress(torch.from_numpy(arr))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        if arr is x:
            assert tq[0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
    assert not tq.any() and float(ts[0, 0]) == np.float32(1e-12)


def _one_device(fn, *args):
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("pod",))
    return jax.shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P())(*args)


def test_compressed_psum_world_of_one_equals_reference():
    x = _x((4, 300), seed=1, scale=0.1)
    want = _one_device(lambda t: jopt.compressed_psum(t, "pod"),
                       jnp.asarray(x))
    got = topt.compressed_psum(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_error_feedback_equals_reference():
    grads = {"w": _x((33, 17), seed=2), "b": {"x": _x((300,), seed=3)}}
    jres = jopt.ErrorFeedback.init(jax.tree.map(jnp.asarray, grads))
    tres = topt.ErrorFeedback.init(topt.tree_map(torch.from_numpy, grads))
    apply = jax.jit(lambda g, r: _one_device(
        lambda g, r: jopt.ErrorFeedback.apply(g, r, "pod"), g, r))
    for step in range(5):
        g = {"w": _x((33, 17), seed=10 + step), "b": {"x": _x((300,), seed=20
                                                          + step)}}
        jout, jres = apply(jax.tree.map(jnp.asarray, g), jres)
        tout, tres = topt.ErrorFeedback.apply(
            topt.tree_map(torch.from_numpy, g), tres)
        for o, jo, r, jr in zip(topt.tree_leaves(tout), jax.tree.leaves(jout),
                                topt.tree_leaves(tres), jax.tree.leaves(jres)):
            np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=ULP,
                                       atol=0)
            # a residual is a difference of values of the outputs' size
            np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0,
                                       atol=ULP * float(np.abs(jo).max()))


def test_error_feedback_reduces_bias():
    """The reference's test: with feedback, repeated compressed sums of
    tiny values beside an outlier track the true sum."""
    x = torch.tensor([1e-4, 5e-4, -2e-4] * 10 + [1.0])
    total_plain = torch.zeros_like(x)
    total_ef = torch.zeros_like(x)
    resid = torch.zeros_like(x)
    for _ in range(50):
        q, s, pad = topt.int8_compress(x)
        total_plain = total_plain + topt.int8_decompress(q, s, pad, x.shape)
        corr = x + resid
        q, s, pad = topt.int8_compress(corr)
        deq = topt.int8_decompress(q, s, pad, x.shape)
        resid = corr - deq
        total_ef = total_ef + deq
    want = 50 * x
    assert float(torch.linalg.norm(total_ef - want)) < 0.5 * float(
        torch.linalg.norm(total_plain - want))
