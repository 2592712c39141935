"""Port parity: NGP training (``repro.core.train``) at the small config.

One step's loss and gradients and three steps' losses and params are
held against the reference's on the same JAX-initialised params, the
reference's own batch indices and the jitter ``jax.random.uniform(skey,
(R, S))`` that its ``render_fixed`` draws from the step key.  Torch-trained
params render in the reference; the reference test's short run passes its
loss gate here too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.core import model as jmodel
from repro.core import scene as jsc
from repro.core import train as jtrain
from repro_torch import optim as topt
from repro_torch import params as tparams
from repro_torch.core import model as tmodel
from repro_torch.core import scene as tsc
from repro_torch.core import train as ttrain

CFG = dict(scene="lego", steps=3, batch_rays=256, n_samples=32, lr=5e-3,
           n_views=4, view_hw=(32, 32), seed=0, log_every=1)


@pytest.fixture(scope="module")
def setup():
    """Both sides' configs, the reference's init and batches (as its
    train_ngp draws them) and both sides' training rays."""
    jcfg = jtrain.NGPTrainConfig(**CFG)
    tcfg = ttrain.NGPTrainConfig(**CFG)
    mcfg = jmodel.NGPConfig.small()
    key = jax.random.PRNGKey(jcfg.seed)
    key, init_key = jax.random.split(key)
    params = jmodel.init_ngp(init_key, mcfg)
    jrays = jtrain._make_view_rays(jcfg, jsc.make_scene(jcfg.scene))
    trays = ttrain._make_view_rays(tcfg, tsc.make_scene(tcfg.scene),
                                   device="cpu")
    batches = []
    for _ in range(jcfg.steps):
        key, bkey, skey = jax.random.split(key, 3)
        idx = jax.random.randint(bkey, (jcfg.batch_rays,), 0,
                                 jrays[0].shape[0])
        jitter = jax.random.uniform(skey, (jcfg.batch_rays, jcfg.n_samples))
        batches.append((idx, skey, np.asarray(idx), np.asarray(jitter)))
    return jcfg, tcfg, mcfg, params, jrays, trays, batches


def _tparams(params, mcfg):
    field = tparams.from_jax_params(jax.tree.map(np.asarray, params), mcfg,
                                    device="cpu")
    return field.cfg, field.params()


def _tbatch(trays, idx, jitter):
    i = torch.from_numpy(idx.astype(np.int64))
    return tuple(r[i] for r in trays) + (torch.from_numpy(jitter.copy()),)


def test_view_rays_match_reference(setup):
    _, _, _, _, jrays, trays, _ = setup
    for got, want in zip(trays[:2], jrays[:2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(trays[2].numpy(), np.asarray(jrays[2]),
                               rtol=1e-4, atol=1e-5)


def test_one_step_loss_and_grads_match_reference(setup):
    """Loss at rtol 1e-5; each grad leaf within 1e-4 of its largest |g|."""
    jcfg, tcfg, mcfg, params, jrays, trays, batches = setup
    jidx, skey, idx, jitter = batches[0]

    @jax.jit
    def value_and_grad(p, o, d, ref, key):
        def loss_fn(p):
            rgb, _ = jmodel.render_fixed(p, mcfg, o, d, jcfg.n_samples, key)
            return jnp.mean((rgb - ref) ** 2)
        return jax.value_and_grad(loss_fn)(p)

    jloss, jgrads = value_and_grad(params, *(r[jidx] for r in jrays), skey)
    pcfg, tp = _tparams(params, mcfg)
    tloss, tgrads = ttrain.loss_and_grads(tp, pcfg, *_tbatch(trays, idx,
                                                             jitter),
                                          tcfg.n_samples)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    leaves = list(zip(topt.tree_leaves(tgrads), jax.tree.leaves(jgrads)))
    assert len(leaves) == 6
    for got, want in leaves:
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
        assert np.abs(want).max() > 0


def _three_steps(setup):
    jcfg, tcfg, mcfg, params, jrays, trays, batches = setup
    opt_j = jopt.AdamWConfig(lr=jcfg.lr, b2=0.99, eps=1e-15)
    opt_t = topt.AdamWConfig(lr=tcfg.lr, b2=0.99, eps=1e-15)
    jstep = jtrain.make_train_step(jcfg, mcfg, opt_j)
    tstep = ttrain.make_train_step(tcfg, tmodel.NGPConfig.small(), opt_t)
    jsched = jopt.cosine_schedule(jcfg.lr, jcfg.steps)
    tsched = topt.cosine_schedule(tcfg.lr, tcfg.steps)
    jp, js = params, jopt.adamw_init(params, opt_j)
    _, tp = _tparams(params, mcfg)
    ts = topt.adamw_init(tp, opt_t)
    losses = []
    for i, (jidx, skey, idx, jitter) in enumerate(batches):
        jp, js, jl = jstep(jp, js, *(r[jidx] for r in jrays), skey,
                           jsched(jnp.asarray(i)))
        tp, ts, tl = tstep(tp, ts, *_tbatch(trays, idx, jitter), tsched(i))
        losses.append((float(tl), float(jl)))
    return jp, tp, losses


@pytest.fixture(scope="module")
def three_steps(setup):
    return _three_steps(setup)


def test_three_steps_match_reference(setup, three_steps):
    """Losses at rtol 1e-4.  Adam's first steps move an entry by about
    lr * sign(g) (eps 1e-15), so an entry whose gradient lies within
    rounding of 0 may move the other way in the two packages: at least
    99.9 % of each leaf within atol 1e-6 + rtol 1e-4, and every entry
    within 3 lr (three steps of at most ~lr each)."""
    jp, tp, losses = three_steps
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-4)
    lr = setup[0].lr
    for got, want in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
        got, want = got.numpy(), np.asarray(want)
        err = np.abs(got - want)
        close = err <= 1e-6 + 1e-4 * np.abs(want)
        assert close.mean() >= 0.999, (got.shape, close.mean())
        assert err.max() <= 3 * lr
    assert losses[-1][0] < losses[0][0]


def test_torch_trained_params_render_in_reference(setup, three_steps):
    """to_jax_params of the torch-trained field through the reference's
    render_fixed, against the port's, at rtol 1e-4 / atol 1e-5."""
    _, tcfg, mcfg, _, jrays, trays, _ = setup
    _, tp, _ = three_steps
    field = tmodel.NGPField.from_params(tmodel.NGPConfig.small(), tp)
    back = tparams.to_jax_params(field)
    sl = slice(0, 300)
    want, _ = jmodel.render_fixed(back, mcfg, jrays[0][sl], jrays[1][sl], 48)
    got, _ = tmodel.render_fixed(field, trays[0][sl], trays[1][sl], 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_short_training_run_passes_the_reference_gate():
    """The reference's own test config and gate (tests/test_ngp_train.py):
    the loss falls below 0.4x its first value, the tables stay finite."""
    cfg = ttrain.NGPTrainConfig(steps=60, batch_rays=512, n_samples=32,
                                n_views=4, view_hw=(48, 48), log_every=30)
    field, mcfg, scene_field, hist = ttrain.train_ngp(cfg, device="cpu",
                                                      verbose=False)
    first, last = hist[0][1], hist[-1][1]
    assert [h[0] for h in hist] == [0, 30, 59]
    assert last < first * 0.4, hist
    assert all(bool(torch.isfinite(b).all()) for b in field.buffers())
    assert mcfg == tmodel.NGPConfig.small()
    assert not any(b.requires_grad for b in field.buffers())
    assert hist[0][2] <= hist[1][2] <= hist[2][2]


def test_train_ngp_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train_ngp(ttrain.NGPTrainConfig(steps=1), verbose=False)


def test_generator_fixes_the_run():
    """One seed, one run: the init, batches and jitter come from the
    config's seed."""
    cfg = ttrain.NGPTrainConfig(steps=2, batch_rays=64, n_samples=8,
                                n_views=2, view_hw=(8, 8), log_every=1,
                                seed=5)
    runs = [ttrain.train_ngp(cfg, device="cpu", verbose=False)
            for _ in range(2)]
    assert [h[1] for h in runs[0][3]] == [h[1] for h in runs[1][3]]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0].buffers(),
                                                 runs[1][0].buffers()))
