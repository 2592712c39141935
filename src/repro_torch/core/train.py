"""Instant-NGP training on the analytic scenes (``repro.core.train``).

Photometric MSE of the fixed-count render against the analytic scene's
reference colours on rays from a ring of training views; the global norm
clipped at 1.0, then AdamW on a cosine schedule.  Eager torch: autograd
runs through the plain-torch field (``model.param_fns``), as the
reference's ``jax.grad`` runs through its plain field; the kernels have
no backward and are not on this path.  The trained tensors become an
``NGPField`` for rendering, so a kernel field built from it packs the
trained weights.

The view poses come from numpy ``default_rng(seed)``, as the reference
draws them; the init, the batch's ray indices and the stratification
jitter follow the reference's key sequence through ``prng`` (its
``jax.random``), so for the same seed they are the reference's draws, on
any device.  ``make_train_step`` takes the indices' rays and the jitter
as tensors.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Tuple

import numpy as np
import torch

from .. import optim, prng
from ..device import resolve_device
from . import model as model_lib
from . import pipeline
from . import scene as scene_lib


@dataclasses.dataclass(frozen=True)
class NGPTrainConfig:
    scene: str = "lego"
    steps: int = 300
    batch_rays: int = 1024
    n_samples: int = 48
    lr: float = 5e-3
    n_views: int = 12
    view_hw: Tuple[int, int] = (96, 96)
    seed: int = 0
    log_every: int = 50


def _make_view_rays(cfg: NGPTrainConfig, field, device=None):
    """Rays (origins, dirs) of a ring of training views and the analytic
    field's reference colours for them, each (n_views * H * W, 3)."""
    dev = resolve_device(device)
    outs = []
    rng = np.random.default_rng(cfg.seed)
    for v in range(cfg.n_views):
        theta = 2.0 * np.pi * v / cfg.n_views + rng.uniform(0, 0.1)
        phi = rng.uniform(0.35, 0.8)
        cam = scene_lib.look_at_camera(*cfg.view_hw, theta=theta, phi=phi)
        o, d = scene_lib.camera_rays(cam, device=dev)
        ref, _ = scene_lib.render_reference(field, o, d)
        outs.append((o, d, ref))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def loss_and_grads(params, model_cfg: model_lib.NGPConfig, o, d, ref,
                   jitter, n_samples: int):
    """(loss, grads) of the MSE of the fixed-``n_samples`` render of rays
    (o, d) with stratification ``jitter`` (R, n_samples) against ``ref``;
    grads in the params' layout."""
    leaves = [p.detach().requires_grad_() for p in optim.tree_leaves(params)]
    it = iter(leaves)
    live = optim.tree_map(lambda _: next(it), params)
    rgb, _ = pipeline.render_fixed_fns(model_lib.param_fns(live, model_cfg),
                                       o, d, n_samples, jitter)
    loss = torch.mean((rgb - ref) ** 2)
    it = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), optim.tree_map(lambda _: next(it), params)


def make_train_step(cfg: NGPTrainConfig, model_cfg: model_lib.NGPConfig,
                    opt_cfg: optim.AdamWConfig):
    """step(params, opt_state, o, d, ref, jitter, lr) -> (params,
    opt_state, loss): one clipped AdamW step on a batch of rays."""
    def step(params, opt_state, o, d, ref, jitter, lr):
        loss, grads = loss_and_grads(params, model_cfg, o, d, ref, jitter,
                                     cfg.n_samples)
        grads, _ = optim.clip_by_global_norm(grads, 1.0)
        params, opt_state = optim.adamw_update(grads, opt_state, params,
                                               opt_cfg, lr)
        return params, opt_state, loss

    return step


def batch_draws(key, cfg: NGPTrainConfig, n_rays: int, device):
    """One step's draws, as the reference's loop makes them: ``key`` split
    in three (the next key, the batch's, the jitter's), the batch's ray
    indices ``randint(bkey, (batch_rays,), 0, n_rays)`` and the sampling
    jitter ``uniform(skey, (batch_rays, n_samples))``.  Returns (key, idx,
    jitter)."""
    key, bkey, skey = prng.split(key, 3)
    idx = prng.randint(bkey, (cfg.batch_rays,), 0, n_rays, device=device)
    jitter = prng.uniform(skey, (cfg.batch_rays, cfg.n_samples),
                          device=device)
    return key, idx, jitter


def train_ngp(cfg: NGPTrainConfig = NGPTrainConfig(),
              model_cfg: model_lib.NGPConfig | None = None, device=None,
              verbose: bool = True):
    """Train on ``device`` (the GPU unless ``device="cpu"``): the init
    from ``PRNGKey(cfg.seed)`` split in two, then ``batch_draws`` a step,
    the reference's draws for the same seed.  Returns (field, model_cfg,
    scene_field, history): the trained ``NGPField``, and (step, loss,
    seconds since the first step began) at every ``log_every``-th step
    and the last, each read after the step's work ended."""
    dev = resolve_device(device)
    model_cfg = model_cfg or model_lib.NGPConfig.small()
    field = scene_lib.make_scene(cfg.scene)
    key, init_key = prng.split(prng.PRNGKey(cfg.seed))
    params = model_lib.init_ngp(model_cfg, init_key, dev)

    opt_cfg = optim.AdamWConfig(lr=cfg.lr, b2=0.99, eps=1e-15)
    opt_state = optim.adamw_init(params, opt_cfg)
    sched = optim.cosine_schedule(cfg.lr, cfg.steps)

    o, d, ref = _make_view_rays(cfg, field, dev)
    n_rays = o.shape[0]
    step = make_train_step(cfg, model_cfg, opt_cfg)

    history = []
    t0 = time.perf_counter()
    for i in range(cfg.steps):
        key, idx, jitter = batch_draws(key, cfg, n_rays, dev)
        params, opt_state, loss = step(params, opt_state, o[idx], d[idx],
                                       ref[idx], jitter, sched(i))
        if i % cfg.log_every == 0 or i == cfg.steps - 1:
            history.append((i, float(loss), time.perf_counter() - t0))
            if verbose:
                print(f"[train_ngp {cfg.scene}] step {i:4d} loss "
                      f"{history[-1][1]:.5f} ({history[-1][2]:.1f}s)")
    return (model_lib.NGPField.from_params(model_cfg, params), model_cfg,
            field, history)
