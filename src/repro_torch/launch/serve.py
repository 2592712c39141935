"""LM serve launcher (``repro.launch.serve``): batched generation with the
slot engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch gemma2-27b --requests 8 --prompt-len 16 --max-new 32

runs on the CPU; without ``--device`` it runs on the GPU (``cuda``),
where prefill attention launches the flash kernel.  As in the reference,
``--smoke`` is a ``store_true`` flag that defaults to True, so the CLI
always builds the arch's ``SMOKE`` config, in float32, with weights from
``PRNGKey(0)``; ``chip_smoke.py`` drives the full-width gemma2-27b
through the engine.  The VLM and the encoder-decoder (paligemma-3b,
whisper-medium) are refused with a ``ValueError`` before anything is
built: the engine cannot serve them (``engine.require_servable``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

import repro_torch.configs as configs
from repro_torch import prng
from repro_torch.models import lm
from repro_torch.serve.engine import (Request, ServeConfig, ServingEngine,
                                      require_servable)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-27b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    cfg = dataclasses.replace(cfg, dtype="float32")
    require_servable(cfg)
    api = lm.build(cfg, remat_policy=None, device=args.device)
    values = api.init(prng.PRNGKey(0))
    eng = ServingEngine(api, values, ServeConfig(
        max_seq=args.prompt_len + args.max_new + 8,
        slots=args.slots, temperature=args.temperature), device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, size=args.prompt_len),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    done = eng.generate(reqs)
    dt = time.time() - t0
    tok = sum(len(r.out) for r in done)
    print(f"[serve {cfg.name}] {len(done)} requests, {tok} tokens, "
          f"{dt:.2f}s, {tok/dt:.1f} tok/s (attention {api.attention}, "
          f"{api.device})")
    return done


if __name__ == "__main__":
    main()
