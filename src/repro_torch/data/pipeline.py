"""Deterministic-by-step data pipelines (``repro.data.pipeline``).

Every batch is a pure function of (seed, step): a restarted worker
replays the same stream, with nothing lost or repeated and no queue to
drain.  The draws are the reference's ``jax.random`` ones through
``repro_torch.prng``, so a seed and a step give the reference's batch.

``TokenPipeline`` makes language-model token batches: Zipfian unigram
draws by the inverse CDF, each phrase of ``phrase_len`` tokens repeating
its first half (so a model can lower its loss by learning bigrams).  Its
float32 arithmetic is the reference's as XLA runs it on the CPU:
``vocab ** (1 - a)`` is a Python float (float64) that the weak-typed
multiply rounds to float32, and the power with exponent 1 / (1 - a)
(-10 in float32 at a = 1.1) is the C library's ``powf``, which XLA's CPU
``pow`` equals bit for bit and ``torch.pow`` does not (it differs on 1.8 %
of bases in [0.29, 1), enough to move a token at vocab 256,000).  So the
tokens are made on the host, ``powf`` called through ctypes, then moved
to the pipeline's device.

``RayPipeline`` yields (origin, direction, reference colour) batches of
the analytic scenes' training views for Instant-NGP.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
from typing import Any, Iterator, Tuple

import numpy as np
import torch

from .. import prng
from ..device import resolve_device

@functools.cache
def _libm_powf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def powf(base: np.ndarray, exponent: float) -> np.ndarray:
    """The C library's float32 ``powf(b, exponent)`` for each b of
    ``base``, on the host."""
    fn, e = _libm_powf(), float(np.float32(exponent))
    flat = np.asarray(base, np.float32).ravel().tolist()
    out = np.fromiter((fn(b, e) for b in flat), np.float32, len(flat))
    return out.reshape(np.shape(base))


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    """Token batches on ``device`` (the GPU unless ``device="cpu"``)."""
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_exponent: float = 1.1
    phrase_len: int = 8
    device: Any = None

    def batch_at(self, step: int) -> torch.Tensor:
        """(batch, seq_len) int32, a pure function of (seed, step)."""
        dev = resolve_device(self.device)
        key = prng.fold_in(prng.PRNGKey(self.seed), step)
        k1, _, _ = prng.split(key, 3)
        # zipf via the inverse CDF of a uniform draw (ranks 1..V)
        u = prng.uniform(k1, (self.batch, self.seq_len), minval=1e-6,
                         maxval=1.0, device="cpu").numpy()
        a = self.zipf_exponent
        scale = np.float32(self.vocab ** (1.0 - a))
        base = scale * u + (np.float32(1) - u)
        ranks = np.floor(powf(base, 1.0 / (1.0 - a)))
        tokens = np.clip(ranks.astype(np.int32) - 1, 0, self.vocab - 1)
        # learnable structure: every phrase repeats its first half
        P = self.phrase_len
        S = self.seq_len // P * P
        t = tokens[:, :S].reshape(self.batch, -1, P)
        t = np.concatenate([t[:, :, :P // 2], t[:, :, :P - P // 2]], axis=-1)
        tokens[:, :S] = t.reshape(self.batch, S)
        return torch.from_numpy(tokens).to(dev)

    def __iter__(self) -> Iterator[torch.Tensor]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass(frozen=True)
class RayPipeline:
    """Ray batches for NGP training, deterministic by step, on ``device``
    (the GPU unless ``device="cpu"``)."""
    scene: str = "lego"
    batch: int = 1024
    n_views: int = 12
    view_hw: Tuple[int, int] = (96, 96)
    seed: int = 0
    device: Any = None

    def materialize(self):
        """The ray pool (origins, dirs, colours), each (n_views * H * W, 3),
        made once."""
        from ..core import scene as scene_lib
        from ..core.train import NGPTrainConfig, _make_view_rays

        cfg = NGPTrainConfig(scene=self.scene, n_views=self.n_views,
                             view_hw=self.view_hw, seed=self.seed)
        return _make_view_rays(cfg, scene_lib.make_scene(self.scene),
                               self.device)

    def batch_at(self, step: int, pool) -> Tuple[torch.Tensor, ...]:
        o, d, c = pool
        key = prng.fold_in(prng.PRNGKey(self.seed), step)
        idx = prng.randint(key, (self.batch,), 0, o.shape[0], device=o.device)
        return o[idx], d[idx], c[idx]
