"""Port parity: the deterministic-by-step pipelines
(``repro_torch.data``) against the reference's ``repro.data``.

``TokenPipeline.batch_at`` equals the reference's token for token at
gemma2-27b's vocab (256,000) over 8 x 2,048 tokens, steps 0-2, where a
power taken with ``torch.pow`` moves tokens (XLA's CPU ``pow`` is the C
library's ``powf``, which the port calls); at mamba2-780m's (50,280),
hymba-1.5b's (32,001) and at small vocabularies too.  The reference's own
tests pass on the port.  ``RayPipeline`` draws the reference's ray
indices: origins and directions equal, colours within rtol 1e-4 / atol
1e-5 (the analytic render's tolerance, ``test_torch_train.py``)."""

import numpy as np
import pytest
import torch

from repro.data import RayPipeline as JRays
from repro.data import TokenPipeline as JTokens
from repro_torch.data import RayPipeline, TokenPipeline
from repro_torch.data.pipeline import powf
from test_torch_lm_train import one_torch_thread  # noqa: F401

CASES = [(256_000, 8, 2048, 0), (50_280, 8, 1024, 0), (32_001, 4, 1024, 5),
         (512, 4, 64, 3), (1000, 16, 256, 0), (128, 2, 19, 9)]


@pytest.mark.parametrize("vocab,batch,seq,seed", CASES)
def test_tokens_equal_reference(vocab, batch, seq, seed):
    j = JTokens(vocab=vocab, batch=batch, seq_len=seq, seed=seed)
    t = TokenPipeline(vocab=vocab, batch=batch, seq_len=seq, seed=seed,
                      device="cpu")
    for step in range(3):
        got = t.batch_at(step)
        assert got.dtype == torch.int32 and got.shape == (batch, seq)
        np.testing.assert_array_equal(got.numpy(), np.asarray(j.batch_at(step)))


def test_powf_is_the_c_librarys():
    """Exact cases, and within an ulp of the float64 power elsewhere."""
    got = powf(np.float32([0.5, 1.0, 2.0, 0.25]), -10.0)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.float32([1024.0, 1.0, 2.0 ** -10,
                                                   2.0 ** 20]))
    base = np.linspace(0.29, 1.0, 1001, dtype=np.float32).reshape(7, 11, 13)
    want = (base.astype(np.float64) ** -10.0).astype(np.float32)
    np.testing.assert_allclose(powf(base, -10.0), want, rtol=1.2e-7)


def test_batches_deterministic_by_step():
    p1 = TokenPipeline(vocab=512, batch=4, seq_len=64, seed=3, device="cpu")
    p2 = TokenPipeline(vocab=512, batch=4, seq_len=64, seed=3, device="cpu")
    assert torch.equal(p1.batch_at(17), p2.batch_at(17))
    assert not torch.equal(p1.batch_at(17), p1.batch_at(18))


def test_tokens_in_range_and_zipfian():
    t = TokenPipeline(vocab=1000, batch=16, seq_len=256,
                      device="cpu").batch_at(0).numpy()
    assert t.min() >= 0 and t.max() < 1000
    assert (t < 10).mean() > 5 * (t >= 500).mean()


def test_phrase_structure_is_learnable():
    p = TokenPipeline(vocab=512, batch=2, seq_len=64, seed=1, phrase_len=8,
                      device="cpu")
    ph = p.batch_at(5).numpy().reshape(2, -1, 8)
    np.testing.assert_array_equal(ph[:, :, :4], ph[:, :, 4:])


def test_iterator_matches_batch_at():
    p = TokenPipeline(vocab=128, batch=2, seq_len=16, seed=9, device="cpu")
    it = iter(p)
    for step in range(3):
        assert torch.equal(next(it), p.batch_at(step))


def test_default_device_is_the_gpu():
    p = TokenPipeline(vocab=128, batch=2, seq_len=16)
    if torch.cuda.is_available():
        assert p.batch_at(0).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p.batch_at(0)


def test_ray_batches_equal_reference():
    kw = dict(scene="lego", batch=64, n_views=2, view_hw=(8, 8), seed=4)
    j, t = JRays(**kw), RayPipeline(**kw, device="cpu")
    jpool, tpool = j.materialize(), t.materialize()
    assert [tuple(x.shape) for x in tpool] == [x.shape for x in jpool]
    for step in range(3):
        (jo, jd, jc), (to, td, tc) = j.batch_at(step, jpool), t.batch_at(
            step, tpool)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                                   atol=1e-5)
