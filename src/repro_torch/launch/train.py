"""LM train launcher (``repro.launch.train``): checkpoint and restart, a
straggler monitor, retries.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
        --steps 50 --ckpt-dir /path/to/ckpt

trains the arch's full config on the GPU (``cuda``) with the reference's
defaults (8 x 128 tokens a step, lr 3e-4, warmup steps // 10,
``remat_policy="full"``); ``--smoke`` takes its ``SMOKE`` config without
remat, and ``--device cpu`` runs on the CPU.  The model is built on the
training route, ``attention.attend_causal``: the flash kernel has no
backward.  Weights come from ``PRNGKey(0)`` (float32 masters; the model
computes in its config's dtype), batches from ``TokenPipeline`` (the
reference's tokens for a step).

As in the reference: a checkpoint directory resumes from its latest
step; a step slower than ``straggler_factor`` x the EMA of step times is
logged; a step that raises (``--fail-at-step`` injects one) restarts
from the last checkpoint, up to ``--max-restarts`` times: the params
are drawn again, then the latest checkpoint restored, and the
deterministic-by-step data replays the same batches.
"""
from __future__ import annotations

import argparse
import time

import torch

import repro_torch.configs as configs
from repro_torch import prng
from repro_torch.ckpt import CheckpointManager
from repro_torch.data import TokenPipeline
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.train.step import TrainConfig, make_train_step


def _batch(cfg, tokens, batch: int, dev):
    b = {"tokens": tokens}
    if cfg.family == "vlm":
        b["img_embeds"] = torch.zeros((batch, cfg.prefix_tokens, cfg.d_model),
                                      dtype=torch.bfloat16, device=dev)
    if cfg.family == "encdec":
        b["frames"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                  dtype=torch.bfloat16, device=dev)
    return b


def train_loop(api, tcfg: TrainConfig, steps: int, batch: int, seq: int,
               ckpt_dir=None, ckpt_every: int = 20, max_restarts: int = 0,
               fail_at_step: int = -1, straggler_factor: float = 3.0,
               verbose: bool = True, timings=None):
    """Train ``api`` (built on its device) for ``steps`` steps of
    (batch, seq) tokens.  Returns (values, opt_state, [(step, loss)]).
    ``timings``, if a list, gets each finished step's (step, seconds),
    the batch and the loss's read-back included."""
    cfg, dev = api.cfg, api.device
    pipe = TokenPipeline(vocab=cfg.vocab, batch=batch, seq_len=seq,
                         device=dev)
    step_fn, opt_init = make_train_step(api.loss_fn, tcfg)

    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    values = api.init(prng.PRNGKey(0))
    opt_state = opt_init(values)
    start = 0
    if mgr and mgr.latest_step() is not None:
        (values, opt_state), start = mgr.restore((values, opt_state))
        start += 1
        if verbose:
            print(f"[train] resumed from step {start - 1}")

    restarts = 0
    losses = []
    ema = None
    i = start
    while i < steps:
        try:
            t0 = time.time()
            tokens = pipe.batch_at(i)
            if i == fail_at_step and restarts < max_restarts:
                raise RuntimeError("injected failure (simulated node loss)")
            values, opt_state, metrics = step_fn(
                values, opt_state, _batch(cfg, tokens, batch, dev), i)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if dt > straggler_factor * ema and i > start + 3:
                print(f"[straggler] step {i} took {dt:.2f}s (ema {ema:.2f}s)")
            losses.append((i, loss))
            if timings is not None:
                timings.append((i, dt))
            if verbose and (i % 10 == 0 or i == steps - 1):
                print(f"[train {cfg.name}] step {i:5d} loss {loss:.4f} "
                      f"({dt:.2f}s)")
            if mgr and (i % ckpt_every == 0 or i == steps - 1):
                mgr.save(i, (values, opt_state))
            i += 1
        except Exception as e:  # noqa: BLE001 — the restart path
            restarts += 1
            if restarts > max_restarts or mgr is None:
                raise
            print(f"[restart {restarts}/{max_restarts}] step {i} failed: {e}")
            values = api.init(prng.PRNGKey(0))
            opt_state = opt_init(values)
            (values, opt_state), last = mgr.restore((values, opt_state))
            i = last + 1
    if mgr:
        mgr.wait()
    return values, opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--max-restarts", type=int, default=0)
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    api = lm.build(cfg, remat_policy=None if args.smoke else "full",
                   attention=attn.attend_causal, device=args.device)
    tcfg = TrainConfig(microbatches=args.microbatches, lr=args.lr,
                       warmup_steps=max(1, args.steps // 10),
                       total_steps=args.steps)
    t0 = time.time()
    _, _, losses = train_loop(
        api, tcfg, args.steps, args.batch, args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        max_restarts=args.max_restarts, fail_at_step=args.fail_at_step)
    print(f"[done] {len(losses)} steps in {time.time()-t0:.1f}s; "
          f"loss {losses[0][1]:.3f} -> {losses[-1][1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
