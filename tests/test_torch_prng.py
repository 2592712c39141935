"""Port parity: ``repro_torch.prng`` against ``jax.random`` (threefry2x32,
partitionable, the installed jax's default) on the CPU.

Keys, ``split``, ``fold_in``, bits, ``uniform`` and ``randint`` are held
bit for bit.  ``normal`` (XLA's float32 erf_inv over log1p) and
``categorical`` (a Gumbel through two logs) are held bit for bit too: the
port reproduces XLA's CPU float32 functions op for op (0 ulps measured).
Then the port's seeded sites against the reference's: ``init_ngp``,
``probe_jitter_for`` and ``train_ngp``'s first batches.  The reference runs
at XLA optimisation level 0 (tests/conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as jmodel
from repro.core import scene as jsc
from repro.core import train as jtrain
from repro_torch import params as tparams
from repro_torch import prng
from repro_torch.core import model as tmodel
from repro_torch.core import scene as tsc
from repro_torch.core import train as ttrain

SEEDS = [0, 7, 2 ** 31 + 3, -1, 2 ** 40 + 5]


def _u32(t):
    return t.numpy().astype(np.uint32)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_is_exact(seed):
    np.testing.assert_array_equal(_u32(prng.PRNGKey(seed)),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_split_is_exact(n):
    for seed in (0, 42):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
        np.testing.assert_array_equal(_u32(prng.split(prng.PRNGKey(seed), n)),
                                      want)
    # a split key splits again as the reference's does
    k = prng.split(prng.PRNGKey(3), 3)[2]
    jk = jax.random.split(jax.random.PRNGKey(3), 3)[2]
    np.testing.assert_array_equal(_u32(prng.split(k, n)),
                                  np.asarray(jax.random.split(jk, n)))


@pytest.mark.parametrize("data", [0, 12345, 2 ** 32 - 1])
def test_fold_in_is_exact(data):
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(9), data))
    np.testing.assert_array_equal(_u32(prng.fold_in(prng.PRNGKey(9), data)),
                                  want)


@pytest.mark.parametrize("shape", [(1001,), (3, 5, 7), ()])
def test_bits_are_exact(shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(11), shape))
    np.testing.assert_array_equal(_u32(prng.bits(prng.PRNGKey(11), shape)),
                                  want)


@pytest.mark.parametrize("lo,hi,shape", [
    (0.0, 1.0, (4099,)), (-1e-4, 1e-4, (16, 257)), (-3.5, 7.25, (5, 3, 11)),
    (float(np.finfo(np.float32).tiny), 1.0, (2048,)),
    (float(np.nextafter(np.float32(-1), np.float32(0))), 1.0, (777,))])
def test_uniform_is_exact(lo, hi, shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), shape,
                                         minval=lo, maxval=hi))
    got = prng.uniform(prng.PRNGKey(5), shape, minval=lo, maxval=hi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0, 16), (0, 10), (0, 1000003),
                                   (-5, 2 ** 24 + 17), (3, 3),
                                   (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)])
def test_randint_is_exact(lo, hi):
    """Powers of two and not, a range above 2^24, an empty one, the widest."""
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (4097,), lo,
                                         hi))
    got = prng.randint(prng.PRNGKey(2), (4097,), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,shape", [(7, (200_000,)), (0, (33, 65)),
                                        (3, (4, 4096))])
def test_normal_is_exact(seed, shape):
    """0 ulps: the tails through erf_inv's sqrt branch included."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    assert _ulps(got, want).max() == 0
    assert np.abs(want).max() > 3.0 or want.size < 10_000


def test_xla_log_and_log1p_are_exact():
    """The float32 functions under normal and the Gumbel, over their whole
    ranges (denormals read as zero, as XLA's CPU reads them)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 1, 50_000), rng.uniform(0.3, 3, 50_000),
                        10 ** rng.uniform(-45, 38, 50_000)]).astype(np.float32)
    got = prng.xla_log(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.log)(x))
    assert _ulps(got, want).max() == 0
    y = np.concatenate([-rng.uniform(0, 1, 50_000), rng.uniform(-0.5, 5, 50_000),
                        10 ** rng.uniform(-36, 30, 50_000)]).astype(np.float32)
    got = prng.xla_log1p(torch.from_numpy(y)).numpy()
    want = np.asarray(jax.jit(jnp.log1p)(y))
    assert _ulps(got, want).max() == 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_categorical_samples_are_equal(seed):
    """64 rows of 1,000 logits a key (the Gumbel's values equal too)."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((64, 1000)) * 3.0).astype(np.float32)
    k = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.categorical(k, jnp.asarray(logits), axis=-1))
    got = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        prng.gumbel(prng.PRNGKey(seed), (64, 1000)).numpy(),
        np.asarray(jax.random.gumbel(k, (64, 1000))))


def test_chunked_draws_do_not_depend_on_the_chunk(monkeypatch):
    """A draw made CHUNK counters at a time equals one made whole, and
    ``normal_into`` a bf16 tensor is the float32 draw times the scale, cast."""
    key = prng.PRNGKey(4)
    whole = prng.normal(key, (37, 53))
    monkeypatch.setattr(prng, "CHUNK", 100)
    assert torch.equal(prng.normal(key, (37, 53)), whole)
    out = torch.empty((37, 53), dtype=torch.bfloat16)
    prng.normal_into(out, key, 0.02)
    assert torch.equal(out, (whole * 0.02).to(torch.bfloat16))


def test_init_ngp_equals_the_reference():
    cfg = jmodel.NGPConfig.small(paper_mlp=True)
    want = jax.tree.leaves(jmodel.init_ngp(jax.random.PRNGKey(0), cfg))
    got = jax.tree.leaves(tmodel.init_ngp(tparams._port_config(cfg),
                                          prng.PRNGKey(0), device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_probe_jitter_equals_the_reference():
    """``probe_jitter_for`` is ``uniform(PRNGKey(probe_seed + rid), (probe
    rays, ns_full))``, the draws the reference's probe takes."""
    from repro_torch.core.pipeline import ASDRConfig
    from repro_torch.serve import admission as tadm
    acfg = ASDRConfig(ns_full=64, probe_stride=4)
    req = tadm.RenderRequest(rid=3, scene="mic",
                             cam=tsc.look_at_camera(30, 30, 0.7, 0.5))
    got = tadm.probe_jitter_for(tadm.RenderServeConfig(probe_seed=11), req,
                                acfg, "cpu")
    want = jax.random.uniform(jax.random.PRNGKey(14), (64, 64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_train_ngp_draws_equal_the_reference():
    """The init and the first three steps' batch indices and jitter of
    ``train_ngp`` are the reference loop's (``core/train.py:86-103``)."""
    cfg = dict(steps=3, batch_rays=256, n_samples=16, n_views=2,
               view_hw=(16, 16), seed=3)
    jcfg, tcfg = jtrain.NGPTrainConfig(**cfg), ttrain.NGPTrainConfig(**cfg)
    n_rays = 2 * 16 * 16
    key = jax.random.PRNGKey(jcfg.seed)
    key, init_key = jax.random.split(key)
    tkey, tinit = prng.split(prng.PRNGKey(tcfg.seed))
    np.testing.assert_array_equal(_u32(tinit), np.asarray(init_key))
    for _ in range(jcfg.steps):
        key, bkey, skey = jax.random.split(key, 3)
        idx = jax.random.randint(bkey, (jcfg.batch_rays,), 0, n_rays)
        jitter = jax.random.uniform(skey, (jcfg.batch_rays, jcfg.n_samples))
        tkey, tidx, tjit = ttrain.batch_draws(tkey, tcfg, n_rays, "cpu")
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
        np.testing.assert_array_equal(tjit.numpy(), np.asarray(jitter))
    rays = ttrain._make_view_rays(tcfg, tsc.make_scene("lego"), "cpu")
    assert rays[0].shape[0] == n_rays
    jrays = jtrain._make_view_rays(jcfg, jsc.make_scene("lego"))
    assert jrays[0].shape[0] == n_rays
