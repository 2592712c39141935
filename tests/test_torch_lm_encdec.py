"""Port parity: the encoder-decoder (``models/encdec.py``, whisper) against
the reference's ``repro.models.encdec``.

At whisper's ``SMOKE`` in float32 (2 + 2 layers, MHA 4 x 16, 16 encoder
frames), on numpy-seeded frames and tokens: the init equals the
reference's value for value (projections (d, H, Dh), the position tables,
the reference's key sequence); ``encode``, ``decode_train``,
``prefill_cross``, ``loss_fn`` and ``prefill_fn`` are within rtol 1e-4 /
atol 1e-5 of the reference's on the carried-across values; a 12-step
``decode_step`` chain from position 0 over the cross K/V equals the
reference's chain step for step and, at its last step, ``decode_train``'s
last logits (the reference test's rule).  ``prefill_fn`` is held twice.
Stage by stage, at rtol 1e-4 / atol 1e-5: its encoder output to the
reference's ``encode``, its logits and cross K/V to the reference's
``decode_train`` and ``prefill_cross`` on that encoder output.  End to
end, to the reference's own outputs, at E2E_ATOL: the reference's
attention logits reach +-67 at ``SMOKE`` (its projections are drawn with
fan_in = H, ``encdec.py:_attn_init``), so a one-ulp difference in a score
moves a softmax weight by ~1e-5 of itself, and the two encoder layers
carry that past atol 1e-5 in a few logits (~0.01 where it does) and a few
cross K/V entries (which reach +-15).  ``decode_train``'s causal
self-attention goes through the route the model was built with, once a
layer; the encoder's and the cross-attention never do.  The engine and
the launcher refuse the encoder-decoder, which the reference's engine
fails on.  The reference is called once per case (module fixtures)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import config as jconfig
from repro.models import encdec as jE
from repro.models import lm as jlm
from repro.serve import engine as jeng
from repro_torch import params as tparams
from repro_torch import prng
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import serve as tlaunch
from repro_torch.models import encdec as tE
from repro_torch.models import lm as tlm
from repro_torch.models import params as tpp
from repro_torch.models import transformer as ttfm
from repro_torch.serve import engine as teng

RTOL, ATOL = 1e-4, 1e-5
# prefill_fn end to end (see the module docstring): (logits, cross K/V)
E2E_ATOL = (5e-5, 3e-4)
ARCH = "whisper_medium"
B, S = 2, 12


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def ed():
    """Both APIs at the smoke config (float32), the reference's params and
    each reference function's outputs on seeded frames and tokens, with
    its decode chain's logits."""
    jc = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    tc = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    japi = jlm.build(jc, remat_policy=None)
    tapi = tlm.build(tc, remat_policy=None, device="cpu")
    jv = japi.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, jc.encoder_seq, jc.d_model)).astype(
        np.float32)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    enc_out = jE.encode(jv, jc, jb["frames"])
    train = jE.decode_train(jv, jc, jb["tokens"], enc_out)
    ck, cv = jE.prefill_cross(jv, jc, enc_out)
    cache = jE.init_cache(jc, B, S, jnp.float32)._replace(cross_k=ck,
                                                         cross_v=cv)
    steps = []
    for t in range(S):
        lg, cache = japi.decode_fn(jv, cache, jb["tokens"][:, t:t + 1],
                                   jnp.asarray(t))
        steps.append(np.asarray(lg[:, 0]))
    tv = tparams.lm_from_jax_values(jv, tc, device="cpu")
    # the reference's decoder on the port's encoder output
    t_enc = tE.encode(tv, tc, torch.from_numpy(frames)).numpy()
    train_on_t_enc = jE.decode_train(jv, jc, jb["tokens"], jnp.asarray(t_enc))
    ck_t, cv_t = jE.prefill_cross(jv, jc, jnp.asarray(t_enc))
    return dict(jc=jc, tc=tc, japi=japi, tapi=tapi, jv=jv, tv=tv, toks=toks,
                frames=frames, enc_out=np.array(enc_out),
                train=np.asarray(train), ck=np.asarray(ck), cv=np.asarray(cv),
                steps=steps, jloss=float(japi.loss_fn(jv, jb)),
                self_k=np.asarray(cache.self_k),
                train_on_t_enc=np.asarray(train_on_t_enc),
                ck_on_t_enc=np.asarray(ck_t), cv_on_t_enc=np.asarray(cv_t))


def _attend(tc):
    return tlm._route(tc, None, torch.device("cpu"))[0]


def test_init_equals_reference(ed):
    tv = ed["tapi"].init(prng.PRNGKey(0))
    want = jax.tree.leaves(ed["jv"])
    got = tpp.tree_leaves(tv)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_encode_matches(ed):
    _close(tE.encode(ed["tv"], ed["tc"], torch.from_numpy(ed["frames"])),
           ed["enc_out"])


def test_decode_train_matches(ed):
    enc_out = torch.from_numpy(ed["enc_out"])
    got = tE.decode_train(ed["tv"], ed["tc"], torch.from_numpy(ed["toks"]),
                          enc_out, _attend(ed["tc"]))
    assert got.shape == (B, S, ed["tc"].padded_vocab)
    _close(got, ed["train"])


def test_prefill_cross_matches(ed):
    ck, cv = tE.prefill_cross(ed["tv"], ed["tc"],
                              torch.from_numpy(ed["enc_out"]))
    _close(ck, ed["ck"])
    _close(cv, ed["cv"])


def test_loss_and_prefill_fn_match(ed):
    """The loss; ``prefill_fn``'s encoder output against the reference's,
    its logits and cross K/V against the reference's decoder and
    ``prefill_cross`` on that encoder output (see the module docstring)."""
    batch = {"tokens": ed["toks"], "frames": ed["frames"]}
    np.testing.assert_allclose(float(ed["tapi"].loss_fn(ed["tv"], batch)),
                               ed["jloss"], rtol=RTOL, atol=ATOL)
    logits, (enc_out, ck, cv) = ed["tapi"].prefill_fn(ed["tv"], batch)
    for got, want in ((logits, "train_on_t_enc"), (enc_out, "enc_out"),
                      (ck, "ck_on_t_enc"), (cv, "cv_on_t_enc")):
        _close(got, ed[want])


def test_prefill_fn_matches_reference_end_to_end(ed):
    """``prefill_fn``'s logits and cross K/V against the reference's
    ``decode_train`` and ``prefill_cross`` on the reference's own encoder
    output, at E2E_ATOL: a fault in the hand-off from the encoder to the
    decoder fails here."""
    batch = {"tokens": ed["toks"], "frames": ed["frames"]}
    logits, (_, ck, cv) = ed["tapi"].prefill_fn(ed["tv"], batch)
    for got, want, atol in ((logits, "train", E2E_ATOL[0]),
                            (ck, "ck", E2E_ATOL[1]), (cv, "cv", E2E_ATOL[1])):
        np.testing.assert_allclose(got.numpy(), ed[want], rtol=RTOL,
                                   atol=atol)


def test_decode_chain_matches_reference_and_decode_train(ed):
    """init_cache, the cross K/V from prefill_cross, then the tokens one at
    a time from position 0: each step as the reference's; the last as
    decode_train's last position; the self cache as the reference's."""
    tc = ed["tc"]
    ck, cv = tE.prefill_cross(ed["tv"], tc, torch.from_numpy(ed["enc_out"]))
    cache = tE.init_cache(tc, B, S, torch.float32, device="cpu")._replace(
        cross_k=ck, cross_v=cv)
    for t in range(S):
        lg, cache = ed["tapi"].decode_fn(ed["tv"], cache,
                                         ed["toks"][:, t:t + 1], t)
        _close(lg[:, 0], ed["steps"][t])
    _close(lg[:, 0], ed["train"][:, -1])
    _close(cache.self_k, ed["self_k"])


def test_decode_train_routes_causal_self_attention(ed):
    """The route the model was built with takes the decoder's causal
    self-attention, once a layer, global and without softcap; the
    encoder's and the cross-attention go through attend_chunked."""
    calls = []

    def recording(q, k, v, window, softcap):
        calls.append((tuple(q.shape), window, softcap))
        return FA.flash_attention_plain(q, k, v, window, softcap)

    batch = {"tokens": ed["toks"], "frames": ed["frames"]}
    api = tlm.build(ed["tc"], device="cpu", attention=recording)
    logits, _ = api.prefill_fn(ed["tv"], batch)
    tc = ed["tc"]
    assert calls == [((B, S, tc.n_heads, tc.head_dim), 0, 0.0)] * tc.n_layers
    assert torch.equal(logits, ed["tapi"].prefill_fn(ed["tv"], batch)[0])


def test_lm_from_jax_values_on_the_encdec_tree(ed):
    """The encoder and decoder stacks carry across with matrices and the
    position tables in the model's dtype, norms in float32, as
    ``model_init`` stores them; a stack of another depth is refused."""
    tc = ed["tc"]
    v16 = ed["tapi"].init(prng.PRNGKey(4), dtype=torch.bfloat16)
    v32 = ed["tapi"].init(prng.PRNGKey(4))
    back = tparams.lm_to_jax_values(v32)
    again = tparams.lm_from_jax_values(back, tc, device="cpu",
                                       dtype=torch.bfloat16)
    for a, b in zip(tpp.tree_leaves(v16), tpp.tree_leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert v16["enc_pos"].dtype == v16["decoder"]["cross"]["wq"].dtype == \
        torch.bfloat16
    assert v16["decoder"]["pre_cross_norm"].dtype == torch.float32
    shallow = dataclasses.replace(tc, encoder_layers=3)
    with pytest.raises(ValueError, match="3 layers in encoder"):
        tparams.lm_from_jax_values(back, shallow, device="cpu")


def test_specs_and_axes_match_reference():
    """The full config: abstract params on the meta device, the decode
    cache's specs and axes, the batch's specs and axes as the
    reference's."""
    jc, tc = jconfigs.get("whisper-medium"), tconfigs.get("whisper-medium")
    japi, tapi = jlm.build(jc), tlm.build(tc, device="cpu")
    (jshapes, jaxes), (tshapes, taxes) = japi.abstract(), tapi.abstract()
    assert [x.shape for x in jax.tree.leaves(jshapes)] == [
        tuple(x.shape) for x in tpp.tree_leaves(tshapes)]
    assert all(x.device.type == "meta" for x in tpp.tree_leaves(tshapes))
    assert tpp.tree_leaves(taxes) == [tuple(a) for a in jax.tree.leaves(
        jaxes, is_leaf=lambda x: isinstance(x, tuple))]
    jcache, tcache = japi.decode_cache_specs(4, 96), tapi.decode_cache_specs(
        4, 96)
    assert [tuple(x.shape) for x in tcache] == [x.shape for x in jcache]
    assert [tuple(a) for a in tapi.decode_cache_axes(4, 96)] == [
        tuple(a) for a in japi.decode_cache_axes(4, 96)]
    cell = jconfig.SHAPES["prefill_32k"]
    jspecs, tspecs = japi.input_specs(cell), tapi.input_specs(cell)
    assert sorted(jspecs) == sorted(tspecs) == ["frames", "tokens"]
    for name in jspecs:
        assert tuple(tspecs[name].shape) == jspecs[name].shape
    assert tapi.input_axes() == japi.input_axes()


def test_the_decoder_stack_refuses_the_encdec(ed):
    with pytest.raises(ValueError, match="models/encdec.py"):
        ttfm.forward(ed["tv"], ed["tc"], torch.from_numpy(ed["toks"]),
                     _attend(ed["tc"]))


def test_engine_and_launcher_refuse_the_encdec(ed):
    """The reference's engine calls ``prefill_fn(..., max_seq=...)``, which
    the encoder-decoder's does not take (a TypeError); the port's engine
    refuses it up front, saying why, and so does the launcher."""
    req = jeng.Request(rid=0, prompt=ed["toks"][0, :6], max_new=2)
    with pytest.raises(TypeError, match="max_seq"):
        jeng.ServingEngine(ed["japi"], ed["jv"], jeng.ServeConfig(
            max_seq=32)).generate([req])
    with pytest.raises(ValueError, match="no self-KV cache"):
        teng.ServingEngine(ed["tapi"], ed["tv"], teng.ServeConfig(),
                           device="cpu")
    with pytest.raises(ValueError, match="decoder families only"):
        tlaunch.main(["--device", "cpu", "--arch", "whisper-medium"])
