"""Port parity: LM training (``repro_torch.train.step``,
``launch/train.py``, the training route) against the reference's
``repro.train.step`` and ``repro.launch.train``.

At the smoke configs in float32 (minitron-8b, the reference test's
fixture; hymba-1.5b, attention beside the SSM; deepseek-moe-16b at
``capacity_factor`` 8, where its router's softmax is differentiated),
on numpy-seeded (8, 32) tokens and the reference's params carried
across: ``make_loss_and_grads`` at 1 and 4 microbatches gives the loss
within rtol 1e-4 / atol 1e-5 and every gradient leaf finite and within
1e-4 of the leaf's max abs (measured: 2e-6 to 1e-5; the SSM's chunk sums
run in another order, ``models/ssm.py``); three ``make_train_step`` steps
(lr 3e-3, warmup 2) give the metrics within rtol 1e-4 and the params
within atol 1e-5 (measured: 3e-6).  whisper's smoke config, whose
gradients a 2^-20 change of its input moves 4.4e-4 of max abs, within
5e-3.  The reference runs under ``jax.jit``, once per arch (module
fixtures).

Also: clipping; ``cast_params_bf16`` (float32 gradients through the
cast, within bf16 rounding of the reference's); the router's softmax
backward against ``jax.nn.softmax``'s; the remat policies bit-equal on
the dense (gemma2: both softcaps, local and global layers), hybrid and
encoder-decoder smoke configs; the launcher's restart replaying the same
losses, as the reference's test; the launcher on the training route; the
kernels' refusal of a tensor that requires grad."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.data import TokenPipeline as JTokens
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.train import step as jstep
from repro_torch import params as tparams
from repro_torch import prng
from repro_torch.kernels import _build, ops
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import ffn as tffn
from repro_torch.models import lm as tlm
from repro_torch.optim import tree_leaves
from repro_torch.train import step as tstep

RTOL, ATOL = 1e-4, 1e-5
GRAD_REL = 1e-4              # a leaf's max abs error / its max abs
ENCDEC_GRAD_REL = 5e-3       # whisper's, at its conditioning (below)
PARAM_ATOL = 1e-5            # after three AdamW steps
ARCHS = ["minitron_8b", "hymba_1_5b", "deepseek_moe_16b"]
MICROBATCHES = (1, 4)
STEP_CFG = dict(lr=3e-3, warmup_steps=2, total_steps=30)
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for this module: beside the suite's other
    workers its intra-op threads contend for the cores, and a smoke
    train step takes 1.2 s where one thread takes 0.02 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name, **kw):
    kw.setdefault("dtype", "float32")
    if name.startswith("deepseek"):
        kw["capacity_factor"] = 8.0
    return (dataclasses.replace(jconfigs.get_smoke(name), **kw),
            dataclasses.replace(tconfigs.get_smoke(name), **kw))


def _tokens(vocab, shape=(8, 32), seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _train_api(tc, remat=None):
    return tlm.build(tc, remat_policy=remat, attention=tattn.attend_causal,
                     device="cpu")


def _both_params(tc):
    """The port's init (the reference's draws, ``test_torch_lm_models``)
    and the same values as the reference's tree of arrays."""
    tv = _train_api(tc).init(prng.PRNGKey(0))
    return tv, jax.tree.map(jnp.asarray, tparams.lm_to_jax_values(tv))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """The params, and the reference's jitted loss and gradients at each
    microbatch count on numpy-seeded tokens."""
    jc, tc = _configs(request.param)
    tv, jv = _both_params(tc)
    japi = jlm.build(jc, remat_policy=None)
    toks = _tokens(jc.vocab)
    grads = {}
    for mb in MICROBATCHES:
        loss, g = jax.jit(jstep.make_loss_and_grads(japi.loss_fn, mb))(
            jv, {"tokens": jnp.asarray(toks)})
        grads[mb] = (float(loss), [np.asarray(x) for x in jax.tree.leaves(g)])
    return dict(tc=tc, tv=tv, toks=toks, grads=grads)


def _close_grads(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.dtype == np.float32 and np.isfinite(g).all()
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= GRAD_REL * scale or err == 0.0, (err, scale)


@pytest.mark.parametrize("mb", MICROBATCHES)
def test_loss_and_grads_match(arch, mb):
    api = _train_api(arch["tc"])
    loss, grads = tstep.make_loss_and_grads(api.loss_fn, mb)(
        arch["tv"], {"tokens": torch.from_numpy(arch["toks"])})
    want_loss, want = arch["grads"][mb]
    np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL, atol=ATOL)
    assert not loss.requires_grad
    _close_grads(tree_leaves(grads), want)


def test_encdec_loss_and_grads_match():
    """whisper's smoke config on numpy-seeded frames: the loss within rtol
    1e-4 / atol 1e-5 and each gradient leaf within ENCDEC_GRAD_REL of
    its max abs.  Its attention logits are large at the reference's init
    (ROADMAP §3): scaling its frames by 1 + 2^-20 moves its gradients
    4.4e-4 of max abs, and the port's are 7.5e-4 (zero frames: 1.3e-3)
    from the reference's."""
    jc, tc = _configs("whisper_medium")
    tv, jv = _both_params(tc)
    japi = jlm.build(jc, remat_policy=None)
    toks = _tokens(jc.vocab)
    frames = np.random.default_rng(0).standard_normal(
        (8, jc.encoder_seq, jc.d_model)).astype(np.float32)
    want_loss, want = jax.jit(jstep.make_loss_and_grads(japi.loss_fn, 1))(
        jv, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    loss, grads = tstep.make_loss_and_grads(_train_api(tc).loss_fn, 1)(
        tv, {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL,
                               atol=ATOL)
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(want)):
        w = np.asarray(w)
        assert np.isfinite(g.numpy()).all()
        assert float(np.abs(g.numpy() - w).max()) <= \
            ENCDEC_GRAD_REL * float(np.abs(w).max())


def test_train_steps_match():
    """Three steps of minitron's smoke (the reference test's fixture) on
    ``TokenPipeline`` batches, against the jitted reference's."""
    jc, tc = _configs("minitron_8b")
    values, jv = _both_params(tc)
    japi = jlm.build(jc, remat_policy=None)
    jfn, jinit = jstep.make_train_step(japi.loss_fn,
                                       jstep.TrainConfig(**STEP_CFG))
    jfn = jax.jit(jfn)
    fn, init = tstep.make_train_step(_train_api(tc).loss_fn,
                                     tstep.TrainConfig(**STEP_CFG))
    pipe = JTokens(vocab=jc.vocab, batch=8, seq_len=32)
    opt, jopt = init(values), jinit(jv)
    for i in range(STEPS):
        b = np.array(pipe.batch_at(i))
        jv, jopt, jm = jfn(jv, jopt, {"tokens": jnp.asarray(b)},
                           jnp.asarray(i))
        values, opt, m = fn(values, opt, {"tokens": torch.from_numpy(b)}, i)
        for k, want in jm.items():
            np.testing.assert_allclose(float(m[k]), float(want), rtol=RTOL,
                                       atol=ATOL)
    for g, w in zip(tree_leaves(values), jax.tree.leaves(jv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=PARAM_ATOL)
    assert int(opt["count"]) == STEPS


def test_clipping_and_grad_norm(arch):
    """max_grad_norm ~0 clips everything: the params barely move and the
    reported norm (the reference's test) is the reference gradients'
    global norm."""
    fn, init = tstep.make_train_step(_train_api(arch["tc"]).loss_fn,
                                     tstep.TrainConfig(max_grad_norm=1e-9))
    values = arch["tv"]
    new, _, m = fn(values, init(values),
                   {"tokens": torch.from_numpy(arch["toks"])}, 0)
    d = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(new),
                                                       tree_leaves(values)))
    assert d < 1e-5
    want = np.sqrt(sum(float(np.sum(np.square(g.astype(np.float64))))
                       for g in arch["grads"][1][1]))
    np.testing.assert_allclose(float(m["grad_norm"]), want, rtol=RTOL)


def test_cast_params_bf16():
    """The float32 tree is cast to bf16 before the loss, and gradients
    flow back through the cast as float32, to every leaf: the loss and
    the gradients' global norm are within bf16 rounding (rtol 2e-2) of
    the reference's."""
    jc, tc = _configs("minitron_8b", dtype="bfloat16")
    values, jv = _both_params(tc)
    japi = jlm.build(jc, remat_policy=None)
    toks = _tokens(jc.vocab)
    jloss, jg = jax.jit(jstep.make_loss_and_grads(
        lambda v, b: japi.loss_fn(jparams.cast_tree(v, jnp.bfloat16), b),
        1))(jv, {"tokens": jnp.asarray(toks)})
    api = _train_api(tc)
    seen = []
    fn, init = tstep.make_train_step(
        lambda v, b: seen.append(v) or api.loss_fn(v, b),
        tstep.TrainConfig(cast_params_bf16=True, max_grad_norm=1e9))
    new, _, m = fn(values, init(values), {"tokens": torch.from_numpy(toks)}, 0)
    assert {x.dtype for x in tree_leaves(seen[0])} == {torch.bfloat16}
    assert all(x.dtype == torch.float32 for x in tree_leaves(new))
    jnorm = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64))))
                        for g in jax.tree.leaves(jg)))
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=2e-2)
    np.testing.assert_allclose(float(m["grad_norm"]), jnorm, rtol=2e-2)


def test_router_softmax_backward_is_softmax_rule():
    """``softmax_f32``'s forward is XLA's bit for bit and its gradient
    ``jax.nn.softmax``'s (the custom JVP's rule), not the derivative of
    the exp polynomial."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 40, 64)) * 3).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    @jax.jit
    def ref(x, g):
        y, vjp = jax.vjp(lambda t: jax.nn.softmax(t, axis=-1), x)
        return y, vjp(g)[0]
    y, want = ref(jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    yt = tffn.softmax_f32(xt)
    (got,) = torch.autograd.grad(yt, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("name", ["gemma2_27b", "hymba_1_5b",
                                  "whisper_medium"])
def test_remat_policies_bit_equal(name):
    """None, "full" and "dots" give the same loss and gradients bit for
    bit (recomputation repeats the same ops on the same inputs)."""
    _, tc = _configs(name)
    toks = torch.from_numpy(_tokens(tc.vocab, (1, 16)))
    batch = {"tokens": toks}
    if tc.family == "encdec":
        batch["frames"] = torch.from_numpy(np.random.default_rng(1).normal(
            size=(1, tc.encoder_seq, tc.d_model)).astype(np.float32))
    values = _train_api(tc).init(prng.PRNGKey(0))
    out = {}
    for policy in (None, "full", "dots"):
        api = _train_api(tc, policy)
        out[policy] = tstep.make_loss_and_grads(api.loss_fn, 1)(values, batch)
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out[None][0])
        for a, b in zip(tree_leaves(out[policy][1]), tree_leaves(out[None][1])):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat_policy"):
        _train_api(tc, "some").loss_fn(values, batch)


def test_train_loop_restart_from_checkpoint(tmp_path):
    """An injected failure at step 9 restarts from the step-8 checkpoint
    and replays steps 9-11 as an uninterrupted run (the reference's
    test)."""
    _, tc = _configs("minitron_8b")
    api = _train_api(tc)
    tcfg = tstep.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=12)
    _, _, fail = tlaunch.train_loop(
        api, tcfg, steps=12, batch=4, seq=32, ckpt_dir=tmp_path / "a",
        ckpt_every=4, max_restarts=1, fail_at_step=9, verbose=False)
    _, _, ok = tlaunch.train_loop(
        api, tcfg, steps=12, batch=4, seq=32, ckpt_dir=tmp_path / "b",
        ckpt_every=4, verbose=False)
    d_fail, d_ok = dict(fail), dict(ok)
    assert sorted(d_fail) == list(range(12))
    for s in (10, 11):
        np.testing.assert_allclose(d_fail[s], d_ok[s], rtol=1e-4)
    with pytest.raises(RuntimeError, match="injected"):
        tlaunch.train_loop(api, tcfg, steps=12, batch=4, seq=32,
                           fail_at_step=3, max_restarts=1, verbose=False)


def test_launcher_trains_on_the_training_route(capsys):
    """``main --smoke`` on the CPU builds on ``attend_causal`` and trains;
    the default is the GPU."""
    losses = tlaunch.main(["--arch", "mamba2-780m", "--smoke", "--steps",
                           "2", "--batch", "2", "--seq", "8", "--device",
                           "cpu"])
    assert [s for s, _ in losses] == [0, 1]
    assert all(np.isfinite(l) for _, l in losses)
    assert "[done] 2 steps" in capsys.readouterr().out
    api = tlm.build(tconfigs.get_smoke("mamba2-780m"), device="cpu",
                    attention=tattn.attend_causal)
    assert api.attention == "attend_causal"


def test_kernels_refuse_a_tensor_that_requires_grad():
    """Every wrapper's input check refuses a tensor that requires grad
    while autograd records (the kernels have no backward); under no_grad
    it passes, and on the CPU the flash route's plain version still
    differentiates."""
    t = torch.zeros((2, 3), requires_grad=True)
    cpu = torch.device("cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        _build.require("x", t, torch.float32, 2, cpu)
    with torch.no_grad():
        _build.require("x", t, torch.float32, 2, cpu)
    _build.require("x", t.detach(), torch.float32, 2, cpu)
    q = torch.randn((1, 8, 2, 16), requires_grad=True)
    out = ops.flash_attention(q, q[:, :, :1].detach(), q[:, :, :1].detach())
    (g,) = torch.autograd.grad(out.sum(), q)
    assert float(g.abs().sum()) > 0
