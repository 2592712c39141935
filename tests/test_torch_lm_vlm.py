"""Port parity: the prefix VLM (paligemma) against the reference.

At paligemma's ``SMOKE`` in float32 (3 layers, MQA 4 / 1, an image prefix
of 8 tokens), on numpy-seeded tokens and ``img_embeds``: the init equals
the reference's value for value; ``forward``, ``loss_fn`` (the prefix
positions dropped) and ``prefill_fn`` (logits and the caches, the
prefix's K/V first) are within rtol 1e-4 / atol 1e-5 of the reference's
on the carried-across values; decode steps after the prefix (positions
from prefix + prompt on) equal the reference's decode steps and the full
forward at those positions.  The prefix mask is the reference's, the
kernel route is never called (the mask sends the prefill to
``attend_chunked``), and the serving engine and launcher refuse the VLM,
which the reference's engine fails on.  The reference is called once per
case (module fixtures)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import lm as jlm
from repro.models import transformer as jtfm
from repro.serve import engine as jeng
from repro_torch import params as tparams
from repro_torch import prng
from repro_torch.launch import serve as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models import params as tpp
from repro_torch.models import transformer as ttfm
from repro_torch.serve import engine as teng

RTOL, ATOL = 1e-4, 1e-5
ARCH = "paligemma_3b"
PROMPT, NEW = 12, 4
B = 2


@pytest.fixture(scope="module")
def vlm():
    """Both packages' APIs at the smoke config (float32), the reference's
    params, its forward logits and loss over prompt + new tokens, its
    prefill over the prompt and its teacher-forced decode steps."""
    jc = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    tc = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    japi = jlm.build(jc, remat_policy=None)
    tapi = tlm.build(tc, remat_policy=None, device="cpu")
    jv = japi.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jc.vocab, (B, PROMPT + NEW)).astype(np.int32)
    img = rng.standard_normal((B, jc.prefix_tokens, jc.d_model)).astype(
        np.float32)
    jb = {"tokens": jnp.asarray(toks), "img_embeds": jnp.asarray(img)}
    jforward = jax.jit(lambda v, t, i: jtfm.forward(v, jc, t, img_embeds=i)[0])
    jlogits = np.asarray(jforward(jv, jb["tokens"], jb["img_embeds"]))
    jloss = float(japi.loss_fn(jv, jb))
    pfx, max_seq = jc.prefix_tokens, jc.prefix_tokens + PROMPT + NEW
    jpre, jcaches = japi.prefill_fn(
        jv, {"tokens": jb["tokens"][:, :PROMPT], "img_embeds": jb["img_embeds"]},
        max_seq=max_seq)
    jsteps = []
    caches = jcaches
    for t in range(PROMPT, PROMPT + NEW):
        step, caches = japi.decode_fn(jv, caches, jb["tokens"][:, t:t + 1],
                                      jnp.asarray(t + pfx))
        jsteps.append(np.asarray(step[:, 0]))
    tv = tparams.lm_from_jax_values(jv, tc, device="cpu")
    return dict(jc=jc, tc=tc, japi=japi, tapi=tapi, jv=jv, tv=tv, toks=toks,
                img=img, jlogits=jlogits, jloss=jloss, jpre=np.asarray(jpre),
                jcaches=jcaches, jsteps=jsteps, max_seq=max_seq)


def test_init_equals_reference(vlm):
    tv = vlm["tapi"].init(prng.PRNGKey(0))
    want = jax.tree.leaves(vlm["jv"])
    got = tpp.tree_leaves(tv)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_forward_and_loss_match(vlm):
    """Logits over the prefix and the text; the loss over the text
    positions only."""
    tc = vlm["tc"]
    attend = tlm._route(tc, None, torch.device("cpu"))[0]
    logits, _ = ttfm.forward(vlm["tv"], tc, torch.from_numpy(vlm["toks"]),
                             attend, img_embeds=torch.from_numpy(vlm["img"]))
    assert logits.shape[1] == tc.prefix_tokens + PROMPT + NEW
    np.testing.assert_allclose(logits.numpy(), vlm["jlogits"], rtol=RTOL,
                               atol=ATOL)
    loss = vlm["tapi"].loss_fn(vlm["tv"], {"tokens": vlm["toks"],
                                           "img_embeds": vlm["img"]})
    np.testing.assert_allclose(float(loss), vlm["jloss"], rtol=RTOL,
                               atol=ATOL)


def _prefill(vlm):
    return vlm["tapi"].prefill_fn(
        vlm["tv"], {"tokens": vlm["toks"][:, :PROMPT], "img_embeds": vlm["img"]},
        max_seq=vlm["max_seq"])


def test_prefill_matches_reference(vlm):
    """Prefill logits, and each layer's caches: the prefix's and the
    prompt's K/V in the first prefix + prompt slots, zeros after."""
    logits, caches = _prefill(vlm)
    np.testing.assert_allclose(logits.numpy(), vlm["jpre"], rtol=RTOL,
                               atol=ATOL)
    assert len(caches) == len(vlm["jcaches"]) == vlm["tc"].n_layers
    for got, want in zip(caches, vlm["jcaches"]):
        assert got.ssm is None and want.ssm is None
        for g, w in zip(got.kv, want.kv):
            assert tuple(g.shape) == w.shape == (B, vlm["max_seq"], 16)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)


def test_decode_after_the_prefix_matches_reference_and_forward(vlm):
    """Teacher-forced decode steps at positions prefix + t: each step's
    logits equal the reference's decode step and its full forward at that
    position (``tests/test_models.py``'s rule, pos = S - 1 + prefix)."""
    tc = vlm["tc"]
    _, caches = _prefill(vlm)
    for i, t in enumerate(range(PROMPT, PROMPT + NEW)):
        step, caches = vlm["tapi"].decode_fn(
            vlm["tv"], caches, vlm["toks"][:, t:t + 1], t + tc.prefix_tokens)
        np.testing.assert_allclose(step[:, 0].numpy(), vlm["jsteps"][i],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(step[:, 0].numpy(),
                                   vlm["jlogits"][:, tc.prefix_tokens + t],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("prefix,S", [(0, 5), (3, 3), (3, 7), (8, 20)])
def test_prefix_mask_is_the_reference(prefix, S):
    got = ttfm._prefix_mask(prefix, S, "cpu")
    want = jtfm._prefix_mask(prefix, S)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_never_calls_the_kernel_route(vlm):
    """Every layer carries the prefix mask, which the flash kernel does not
    take: the route the model was built with is never called, as the
    reference's prefill runs ``attend_chunked``."""
    calls = []

    def recording(*args):
        calls.append(args)
        raise AssertionError("the kernel route was called")

    api = tlm.build(vlm["tc"], device="cpu", attention=recording)
    logits, _ = api.prefill_fn(vlm["tv"], {"tokens": vlm["toks"][:, :PROMPT],
                                           "img_embeds": vlm["img"]})
    assert not calls
    np.testing.assert_allclose(logits.numpy(), vlm["jpre"], rtol=RTOL,
                               atol=ATOL)


def test_forward_without_img_embeds_raises(vlm):
    with pytest.raises(ValueError, match="img_embeds"):
        vlm["tapi"].prefill_fn(vlm["tv"], {"tokens": vlm["toks"]})


def test_bf16_storage_of_the_vlm_tree(vlm):
    """``lm_from_jax_values`` stores the VLM's leaves as ``model_init``
    does in bf16, and the values carry back."""
    tc = vlm["tc"]
    v16 = vlm["tapi"].init(prng.PRNGKey(3), dtype=torch.bfloat16)
    v32 = vlm["tapi"].init(prng.PRNGKey(3))
    back = tparams.lm_to_jax_values(v32)
    again = tparams.lm_from_jax_values(back, tc, device="cpu",
                                       dtype=torch.bfloat16)
    for a, b in zip(tpp.tree_leaves(v16), tpp.tree_leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_specs_and_axes_match_reference():
    """The full config: abstract params (on the meta device), the batch's
    specs (tokens and img_embeds) and axes as the reference's."""
    jc, tc = jconfigs.get("paligemma-3b"), tconfigs.get("paligemma-3b")
    japi, tapi = jlm.build(jc), tlm.build(tc, device="cpu")
    (jshapes, _), (tshapes, _) = japi.abstract(), tapi.abstract()
    assert [x.shape for x in jax.tree.leaves(jshapes)] == [
        tuple(x.shape) for x in tpp.tree_leaves(tshapes)]
    from repro.models import config as jconfig
    cell = jconfig.SHAPES["prefill_32k"]
    jspecs, tspecs = japi.input_specs(cell), tapi.input_specs(cell)
    assert sorted(jspecs) == sorted(tspecs) == ["img_embeds", "tokens"]
    for name in jspecs:
        assert tuple(tspecs[name].shape) == jspecs[name].shape
        assert str(tspecs[name].dtype).split(".")[-1] == str(
            jspecs[name].dtype)
    assert tapi.input_axes() == japi.input_axes()


def test_engine_and_launcher_refuse_the_vlm(vlm):
    """The reference's engine passes a tokens-only batch and fails on the
    VLM (its forward asserts img_embeds); the port's refuses it up front,
    saying why, and so does the launcher."""
    req = jeng.Request(rid=0, prompt=vlm["toks"][0, :6], max_new=2)
    with pytest.raises(AssertionError):
        jeng.ServingEngine(vlm["japi"], vlm["jv"], jeng.ServeConfig(
            max_seq=32)).generate([req])
    with pytest.raises(ValueError, match="img_embeds"):
        teng.ServingEngine(vlm["tapi"], vlm["tv"], teng.ServeConfig(),
                           device="cpu")
    with pytest.raises(ValueError, match="decoder families only"):
        tlaunch.main(["--device", "cpu", "--arch", "paligemma-3b"])
