"""Port parity: the LM configs, params and the transformer
(``repro_torch.configs``, ``models.config``, ``models.params``,
``models.transformer``, ``models.lm``) against the reference.

All ten configs (and their ``SMOKE``) equal the reference's field by
field, with ``layer_kinds`` and ``param_count``.  For the eight decoder
smoke archs (dense, MoE, SSM, hybrid) at float32: ``api.init(PRNGKey(0))``
equals the reference's value for value (the draws are
``repro_torch.prng``'s); ``forward`` logits and ``loss_fn`` on the
carried-across values are within rtol 1e-4 / atol 1e-5 of the
reference's; prefill plus decode at a prompt longer than the smoke window
(8, so local layers decode through the ring; SSM layers step the state
their prefill handed over) equals a full forward, the MoE archs at
``capacity_factor`` 8.0 as the reference's own decode test (with drops,
prefill and decode legitimately differ).  The reference is called once
per arch (module fixtures)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import config as jconfig
from repro.models import lm as jlm
from repro.models import transformer as jtfm
from repro_torch import params as tparams
from repro_torch import prng
from repro_torch.models import config as tconfig
from repro_torch.models import lm as tlm
from repro_torch.models import params as tpp
from repro_torch.models import transformer as ttfm

RTOL, ATOL = 1e-4, 1e-5
DECODERS = ["gemma2_27b", "minitron_8b", "qwen3_14b", "gemma3_12b",
            "dbrx_132b", "deepseek_moe_16b", "mamba2_780m", "hymba_1_5b"]
NO_DROPS = 8.0                  # the reference's capacity_factor for decode
PROMPT, NEW = 12, 4             # a prompt longer than the smoke window (8)


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_config_equals_reference(arch):
    for get in ("get", "get_smoke"):
        want, got = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert _fields(got) == _fields(want)
        assert got.layer_kinds() == want.layer_kinds()
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert (got.resolved_head_dim, got.padded_vocab) == (
            want.resolved_head_dim, want.padded_vocab)


def test_registry_and_shapes_equal_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.CANONICAL == jconfigs.CANONICAL
    assert tconfigs.ALIAS == jconfigs.ALIAS
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.get("gemma2-27b") == tconfigs.get("gemma2_27b")
    assert {k: dataclasses.astuple(v) for k, v in tconfig.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jconfig.SHAPES.items()}
    assert tconfigs.get("gemma2-27b").param_count() == 27_227_123_712


@pytest.fixture(scope="module", params=DECODERS)
def arch(request):
    """Both packages' APIs at an arch's smoke config (float32), the
    reference's params, and its logits and loss on seeded tokens; for a
    MoE arch also its logits at ``NO_DROPS`` (``jlogits_decode``, what
    decode is held to) and the port's API there."""
    name = request.param
    jc = dataclasses.replace(jconfigs.get_smoke(name), dtype="float32")
    tc = dataclasses.replace(tconfigs.get_smoke(name), dtype="float32")
    japi = jlm.build(jc, remat_policy=None)
    tapi = tlm.build(tc, remat_policy=None, device="cpu")
    jv = japi.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jc.vocab, (2, PROMPT + NEW)).astype(np.int32)
    jforward = jax.jit(lambda v, t, c: jtfm.forward(v, c, t)[0],
                       static_argnums=2)
    jlogits = np.asarray(jforward(jv, jnp.asarray(toks), jc))
    jloss = japi.loss_fn(jv, {"tokens": jnp.asarray(toks)})
    out = dict(name=name, jc=jc, tc=tc, japi=japi, tapi=tapi, jv=jv,
               toks=toks, jlogits=jlogits, jloss=float(jloss),
               jlogits_decode=jlogits, tapi_decode=tapi)
    if jc.family == "moe":
        jc8 = dataclasses.replace(jc, capacity_factor=NO_DROPS)
        out["jlogits_decode"] = np.asarray(jforward(jv, jnp.asarray(toks),
                                                    jc8))
        out["tapi_decode"] = tlm.build(dataclasses.replace(
            tc, capacity_factor=NO_DROPS), remat_policy=None, device="cpu")
    return out


def test_init_equals_reference(arch):
    tv = arch["tapi"].init(prng.PRNGKey(0))
    want = jax.tree.leaves(arch["jv"])
    got = tpp.tree_leaves(tv)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_forward_and_loss_match(arch):
    tv = tparams.lm_from_jax_values(arch["jv"], arch["tc"], device="cpu")
    attend = tlm._route(arch["tc"], None, torch.device("cpu"))[0]
    logits, _ = ttfm.forward(tv, arch["tc"], torch.from_numpy(arch["toks"]),
                             attend)
    np.testing.assert_allclose(logits.numpy(), arch["jlogits"], rtol=RTOL,
                               atol=ATOL)
    loss = arch["tapi"].loss_fn(tv, {"tokens": arch["toks"]})
    np.testing.assert_allclose(float(loss), arch["jloss"], rtol=RTOL,
                               atol=ATOL)


def test_prefill_then_decode_equals_forward(arch):
    """Prefill the first PROMPT tokens, then decode the next NEW one at a
    time (teacher-forced): each step's logits equal the reference forward's
    at that position; local layers run on rings of 8 slots, SSM layers
    step the state their prefill handed over."""
    tc, toks, api = arch["tc"], arch["toks"], arch["tapi_decode"]
    want = arch["jlogits_decode"]
    tv = tparams.lm_from_jax_values(arch["jv"], tc, device="cpu")
    logits, caches = api.prefill_fn(tv, {"tokens": toks[:, :PROMPT]},
                                    max_seq=PROMPT + NEW)
    np.testing.assert_allclose(logits.numpy(), want[:, :PROMPT], rtol=RTOL,
                               atol=ATOL)
    slots = {c.kv.k.shape[1] for c, w in zip(caches, tc.layer_kinds()) if w}
    assert slots <= {tc.window}
    assert all((c.kv is None) == (tc.family == "ssm") for c in caches)
    assert all((c.ssm is not None) == (tc.family in ("ssm", "hybrid"))
               for c in caches)
    for t in range(PROMPT, PROMPT + NEW):
        step, caches = api.decode_fn(tv, caches, toks[:, t:t + 1], t)
        np.testing.assert_allclose(step[:, 0].numpy(), want[:, t], rtol=RTOL,
                                   atol=ATOL)


def test_bf16_storage_is_the_float32_draw_cast_once():
    """``init(key, bfloat16)`` stores each matrix as the float32 draw cast
    once, the norms' scales in float32; the values carry back to the
    reference's layout."""
    tc = dataclasses.replace(tconfigs.get_smoke("gemma2_27b"), n_layers=2)
    api = tlm.build(tc, device="cpu")
    v32 = api.init(prng.PRNGKey(1))
    v16 = api.init(prng.PRNGKey(1), dtype=torch.bfloat16)
    for a, b in zip(tpp.tree_leaves(v32), tpp.tree_leaves(v16)):
        want = a.to(torch.bfloat16) if a.dim() - (a.shape[0] == 2) >= 2 else a
        assert b.dtype == want.dtype and torch.equal(b, want)
    back = tparams.lm_to_jax_values(v32)
    again = tparams.lm_from_jax_values(back, tc, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tpp.tree_leaves(v32),
                                                 tpp.tree_leaves(again)))


@pytest.mark.parametrize("arch_name", ["gemma2-27b", "deepseek-moe-16b",
                                       "mamba2-780m", "hymba-1.5b",
                                       "gemma3-12b", "paligemma-3b"])
def test_abstract_and_specs_match_reference_shapes(arch_name):
    jc, tc = jconfigs.get(arch_name), tconfigs.get(arch_name)
    japi, tapi = jlm.build(jc), tlm.build(tc, device="cpu")
    (jshapes, jaxes), (tshapes, taxes) = japi.abstract(), tapi.abstract()
    assert [x.shape for x in jax.tree.leaves(jshapes)] == [
        tuple(x.shape) for x in tpp.tree_leaves(tshapes)]
    assert all(x.device.type == "meta" for x in tpp.tree_leaves(tshapes))
    assert tpp.tree_leaves(taxes) == [tuple(a) for a in jax.tree.leaves(
        jaxes, is_leaf=lambda x: isinstance(x, tuple))]
    jspecs = japi.decode_cache_specs(4, 4648)
    tspecs = tapi.decode_cache_specs(4, 4648)
    arrays = lambda c: jax.tree.leaves(  # noqa: E731
        tuple(c), is_leaf=lambda t: hasattr(t, "shape"))
    assert [[tuple(x.shape) for x in arrays(c)] for c in tspecs] == [
        [tuple(x.shape) for x in arrays(c)] for c in jspecs]
    assert all(x.device.type == "meta" for c in tspecs for x in arrays(c))
    cell = jconfig.SHAPES["prefill_32k"]
    jin, tin = japi.input_specs(cell), tapi.input_specs(cell)
    assert sorted(tin) == sorted(jin)
    assert all(tuple(tin[k].shape) == jin[k].shape for k in jin)
    assert tapi.input_axes() == japi.input_axes()
    def axes(caches):
        return [[None if a is None else [tuple(x) for x in a] for a in c]
                for c in caches]
    assert axes(tapi.decode_cache_axes(4, 64)) == axes(
        japi.decode_cache_axes(4, 64))


def test_routes_and_families():
    """The kernel route by default (on the CPU its plain version, at any
    head_dim); on the card gemma3-12b's and paligemma-3b's head_dim 256
    takes the kernel, and a head_dim beyond it raises rather than run
    without it, but not for the attention-free SSM family, whose route is
    named and never called; a plain build by request; every family builds,
    the VLM and the encoder-decoder included."""
    assert tlm.build(tconfigs.get("gemma2-27b"), device="cpu").attention == \
        "flash_attention"
    gemma3 = tconfigs.get("gemma3-12b")
    assert tlm.build(gemma3, device="cpu").attention == "flash_attention"
    assert tlm.kernel_takes(gemma3)
    for arch in ("gemma2-27b", "gemma3-12b", "paligemma-3b",
                 "whisper-medium"):
        assert tlm._route(tconfigs.get(arch), None,
                          torch.device("cuda"))[1] == "flash_attention"
    wide = dataclasses.replace(gemma3, head_dim=272)
    assert not tlm.kernel_takes(wide)
    with pytest.raises(NotImplementedError, match="head_dim 272.*up to 256"):
        tlm._route(wide, None, torch.device("cuda"))
    from repro_torch.kernels.flash_attention import flash_attention_plain
    plain = tlm.build(tconfigs.get_smoke("gemma2-27b"), device="cpu",
                      attention=flash_attention_plain)
    assert plain.attention == "flash_attention_plain"
    for arch in ("deepseek-moe-16b", "hymba-1.5b", "mamba2-780m"):
        assert tlm._route(tconfigs.get(arch), None, torch.device("cuda"))[
            1] == "flash_attention"
    for arch in ("dbrx_132b", "deepseek_moe_16b", "mamba2_780m", "hymba_1_5b"):
        api = tlm.build(tconfigs.get_smoke(arch), device="cpu")
        assert api.attention == "flash_attention"
    for arch in ("paligemma_3b", "whisper_medium"):
        api = tlm.build(tconfigs.get_smoke(arch), device="cpu")
        assert api.attention == "flash_attention"
    assert tlm.build(tconfigs.get_smoke("whisper_medium"), device="cpu"
                     ).decode_fn.__qualname__.startswith("_build_encdec")


@pytest.mark.parametrize("arch_name", ["dbrx_132b", "deepseek_moe_16b",
                                       "mamba2_780m", "hymba_1_5b"])
def test_bf16_storage_of_the_new_families(arch_name):
    """``lm_from_jax_values``'s rule (matrices, the conv taps and the
    stacked experts in the model's dtype, 1-D leaves in float32) places
    every MoE and SSM leaf in the dtype ``model_init`` stores it in, with
    the same values."""
    tc = tconfigs.get_smoke(arch_name)
    api = tlm.build(tc, device="cpu")
    v16 = api.init(prng.PRNGKey(2), dtype=torch.bfloat16)
    v32 = api.init(prng.PRNGKey(2))
    again = tparams.lm_from_jax_values(tparams.lm_to_jax_values(v32), tc,
                                       device="cpu", dtype=torch.bfloat16)
    for a, b in zip(tpp.tree_leaves(v16), tpp.tree_leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    one_d = {"A_log", "D", "dt_bias", "norm"}
    for sub in ("moe", "ssm"):
        for name, leaf in v16["layers"].get(sub, {}).items():
            if not isinstance(leaf, dict):
                assert leaf.dtype == (torch.float32 if name in one_d
                                      else torch.bfloat16), name


def test_build_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.build(tconfigs.get_smoke("gemma2_27b"))
