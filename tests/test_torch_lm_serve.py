"""Port parity: the LM slot engine (``repro_torch.serve.engine``) against
the reference's ``ServingEngine`` on ``tests/test_serve.py``'s MICRO
config and on gemma2's, deepseek-moe's and hymba's smoke configs (float32;
the MoE at ``capacity_factor`` 8.0, as the reference's decode test, so
that the rollout property holds without drops), on the same weights
(``api.init(PRNGKey(0))`` in both) and the same requests: greedy tokens
are equal, and tokens sampled at temperature 1.0 from the same seed are
equal (the port's ``prng.categorical`` is ``jax.random.categorical``).
Then the launcher, ``python -m repro_torch.launch.serve --device cpu``,
on gemma2 and on the MoE, SSM and hybrid archs."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JModelConfig
from repro.serve import engine as jeng
from repro_torch import prng
from repro_torch.launch import serve as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttfm
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.serve import engine as teng

MICRO = dict(name="serve-micro", family="dense", n_layers=2, d_model=32,
             n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64, vocab=64,
             act="silu", tie_embeddings=False, dtype="float32")
CONFIGS = {"micro": (JModelConfig(**MICRO), TModelConfig(**MICRO))}
for _arch, _kw in (("gemma2_27b", {}),
                   ("deepseek_moe_16b", dict(capacity_factor=8.0)),
                   ("hymba_1_5b", {})):
    CONFIGS[jconfigs.get_smoke(_arch).name] = tuple(
        dataclasses.replace(c.get_smoke(_arch), dtype="float32", **_kw)
        for c in (jconfigs, tconfigs))
# prompts of two lengths, one longer than the smoke window (8): two waves
# of two slots and a wave of one; max_new differs within a wave
SPEC = [(0, 6, 5), (1, 6, 3), (2, 6, 5), (3, 11, 4), (4, 11, 6)]


def _requests(mod, vocab):
    rng = np.random.default_rng(1)
    return [mod.Request(rid=rid, prompt=rng.integers(0, vocab, size=plen)
                        .astype(np.int32), max_new=new)
            for rid, plen, new in SPEC]


def _run(mod, api, values, cfg, temperature, **kw):
    eng = mod.ServingEngine(api, values, mod.ServeConfig(
        max_seq=24, slots=2, temperature=temperature, seed=3), **kw)
    return {r.rid: r.out for r in eng.generate(_requests(mod, cfg.vocab))}


@pytest.fixture(scope="module", params=list(CONFIGS))
def both(request):
    jc, tc = CONFIGS[request.param]
    japi = jlm.build(jc, remat_policy=None)
    tapi = tlm.build(tc, remat_policy=None, device="cpu")
    jv, tv = japi.init(jax.random.PRNGKey(0)), tapi.init(prng.PRNGKey(0))
    return (jc, japi, jv), (tc, tapi, tv)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_tokens_equal_the_reference_engine(both, temperature):
    (jc, japi, jv), (tc, tapi, tv) = both
    want = _run(jeng, japi, jv, jc, temperature)
    got = _run(teng, tapi, tv, tc, temperature, device="cpu")
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid].dtype == np.int32
        np.testing.assert_array_equal(got[rid], want[rid])
    assert all(len(got[rid]) == new for rid, _, new in SPEC)


def test_greedy_decode_matches_forward_rollout(both):
    """The port's own greedy generation equals the argmax rollout of its
    full forward (as ``tests/test_serve.py`` holds the reference's)."""
    _, (tc, tapi, tv) = both
    prompt = np.asarray([5, 9, 2, 7, 1, 3, 8, 4, 6, 2, 11], dtype=np.int32)
    req = teng.Request(rid=0, prompt=prompt, max_new=5)
    teng.ServingEngine(tapi, tv, teng.ServeConfig(max_seq=24, slots=2),
                       device="cpu").generate([req])
    toks = list(prompt)
    attend = tlm._route(tc, None, torch.device("cpu"))[0]
    for _ in range(5):
        logits, _ = ttfm.forward(tv, tc, torch.tensor([toks]), attend)
        toks.append(int(torch.argmax(logits[0, -1])))
    np.testing.assert_array_equal(req.out, np.asarray(toks[len(prompt):]))


def test_engine_defaults_to_the_gpu(both):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, (tc, tapi, tv) = both
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.ServingEngine(tapi, tv, teng.ServeConfig())


def test_launcher_runs_on_cpu(capsys):
    done = tlaunch.main(["--device", "cpu", "--requests", "3",
                         "--prompt-len", "10", "--max-new", "4"])
    assert len(done) == 3 and all(r.out.shape == (4,) for r in done)
    cfg = tconfigs.get_smoke("gemma2-27b")
    assert all(((r.out >= 0) & (r.out < cfg.vocab)).all() for r in done)
    out = capsys.readouterr().out
    assert "[serve gemma2-smoke] 3 requests, 12 tokens" in out
    assert "attention flash_attention, cpu" in out


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-moe-16b",
                                  "mamba2-780m", "hymba-1.5b"])
def test_launcher_runs_the_new_families(arch, capsys):
    done = tlaunch.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                         "--prompt-len", "10", "--max-new", "3"])
    assert len(done) == 2 and all(r.out.shape == (3,) for r in done)
    cfg = tconfigs.get_smoke(arch)
    assert all(((r.out >= 0) & (r.out < cfg.vocab)).all() for r in done)
    assert f"[serve {cfg.name}] 2 requests, 6 tokens" in \
        capsys.readouterr().out
