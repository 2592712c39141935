"""Batched LM serving engine (``repro.serve.engine``): prefill + decode
with a slot-based batch.

Requests are grouped by exact prompt length into waves of at most
``slots``; a wave is prefilled together (``api.prefill_fn``, whose
self-attention goes through the attention the model was built with, the
flash kernel by default) and then decoded one token a step for all its
slots (``api.decode_fn``, eagerly: there is no jit).  The first token is
drawn from ``PRNGKey(seed)``, each later one from a fresh split of the
running key, through ``prng.categorical`` (the reference's
``jax.random.categorical``); temperature 0 is greedy.  So for the same
model, requests and seed the tokens are the reference engine's.

Like the reference's, the engine serves the decoder families only
(``require_servable``): it passes a tokens-only batch and
``prefill_fn(..., max_seq=...)``, so a VLM would lack its ``img_embeds``
and the encoder-decoder's ``prefill_fn`` takes no ``max_seq`` and hands
over no self-KV cache.  The reference fails on them (an assertion, a
``TypeError``); the port refuses them up front with a ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import prng
from ..device import resolve_device
from ..models import lm as lm_lib


UNSERVED = {
    "vlm": "the VLM needs img_embeds in its batch, and the engine passes "
           "tokens only",
    "encdec": "the encoder-decoder's prefill_fn takes no max_seq and hands "
              "over no self-KV cache (its decode starts from "
              "encdec.init_cache)"}


def require_servable(cfg) -> None:
    """Raise ``ValueError`` for a family the engine cannot serve, saying
    why (``UNSERVED``)."""
    why = UNSERVED.get(cfg.family)
    if why is not None:
        raise ValueError(f"{cfg.name}: the serving engine serves the decoder "
                         f"families only, as the reference's does: {why}")


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 256
    slots: int = 4
    temperature: float = 0.0   # 0 = greedy
    seed: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (P,) int32
    max_new: int = 32
    out: Optional[np.ndarray] = None
    latency_s: float = 0.0


class ServingEngine:
    def __init__(self, api: lm_lib.ModelAPI, values, scfg: ServeConfig,
                 device=None):
        """``values`` on ``device`` (the GPU unless ``device="cpu"``)."""
        require_servable(api.cfg)
        self.api = api
        self.values = values
        self.scfg = scfg
        self.device = resolve_device(device)

    def _sample(self, logits, key):
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        return prng.categorical(key, logits / self.scfg.temperature, axis=-1)

    def generate(self, requests: List[Request]) -> List[Request]:
        """Slot-batched generation: waves of equal prompt length (sorted by
        length), prefilled together, then decoded together."""
        done: List[Request] = []
        by_len: Dict[int, List[Request]] = {}
        for r in requests:
            by_len.setdefault(len(r.prompt), []).append(r)
        for plen, reqs in sorted(by_len.items()):
            for s in range(0, len(reqs), self.scfg.slots):
                done.extend(self._run_wave(reqs[s:s + self.scfg.slots], plen))
        return done

    def _run_wave(self, wave: List[Request], plen: int) -> List[Request]:
        scfg = self.scfg
        t0 = time.perf_counter()
        prompts = torch.from_numpy(
            np.stack([r.prompt for r in wave]).astype(np.int32))
        logits, caches = self.api.prefill_fn(
            self.values, {"tokens": prompts.to(self.device)},
            max_seq=scfg.max_seq)
        key = prng.PRNGKey(scfg.seed)
        tok = self._sample(logits[:, -1], key)[:, None]
        del logits
        outs = [tok]
        pos = plen
        for _ in range(max(r.max_new for r in wave) - 1):
            key, skey = prng.split(key)
            logits, caches = self.api.decode_fn(self.values, caches, tok, pos)
            tok = self._sample(logits[:, 0], skey)[:, None]
            outs.append(tok)
            pos += 1
        gen = torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)
        dt = time.perf_counter() - t0
        for i, r in enumerate(wave):
            r.out = gen[i, : r.max_new]
            r.latency_s = dt
        return wave
