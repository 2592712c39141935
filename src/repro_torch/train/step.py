"""The LM train step (``repro.train.step``): microbatched gradient
accumulation, clipping, AdamW on a warmup-cosine schedule.

``make_train_step(loss_fn, tcfg)`` returns ``train_step(values,
opt_state, batch, step) -> (values, opt_state, metrics)`` and
``opt_init``, as the reference's; eager torch, with autograd over the
params tree's leaves.  The loss must differentiate: an API built on the
flash kernel raises on the card (the kernel has no backward), so the
trainer builds on ``models.attention.attend_causal``
(``launch/train.py``).

Memory posture, as the reference's knobs: params float32, compute in the
model's dtype (the layers cast at use, or the whole tree at once with
``cast_params_bf16``, gradients flowing back through the cast in
float32); microbatches bound the activations; the remat policy is the
model's (``lm.build(cfg, remat_policy)``).  ``adamw_update`` builds new
trees, so the update holds ~12 B a parameter beyond params, gradients
and moments.

One card: ``rules``, ``mesh`` and ``param_axes`` are taken and unused
(``constrain`` is the identity); ``compress_pod_grads`` is declared and
read nowhere, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import optim
from ..models import params as pp


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    max_grad_norm: float = 1.0
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    compress_pod_grads: bool = False   # int8+EF all-reduce over "pod"
    # cast the whole param tree to bf16 before the loss; gradients flow
    # back through the cast to the float32 params
    cast_params_bf16: bool = False


def _value_and_grad(loss_fn, values, batch):
    leaves = [v.detach().requires_grad_() for v in optim.tree_leaves(values)]
    it = iter(leaves)
    live = optim.tree_map(lambda _: next(it), values)
    loss = loss_fn(live, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(leaves, grads)]
    it = iter(grads)
    return loss.detach(), optim.tree_map(lambda _: next(it), values)


def _rows(batch, start: int, stop: int):
    return {k: v[start:stop] for k, v in batch.items()}


def make_loss_and_grads(loss_fn, microbatches: int, constrain_grads=None):
    """grads_fn(values, batch) -> (mean loss, mean grads): with
    ``microbatches`` > 1, the batch's rows in that many slices, loss and
    float32 gradients summed in order from zero and then times
    1 / microbatches, as the reference's scan.  ``constrain_grads``
    (a sharding pin in the reference) is applied to each gradient tree."""
    pin = constrain_grads or (lambda g: g)

    def single(values, batch):
        loss, grads = _value_and_grad(loss_fn, values, batch)
        return loss, pin(grads)

    if microbatches <= 1:
        return single

    def accumulated(values, batch):
        n = len(next(iter(batch.values()))) // microbatches
        dev = optim.tree_leaves(values)[0].device
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        grads_sum = pin(optim.tree_map(
            lambda v: torch.zeros(v.shape, dtype=torch.float32,
                                  device=v.device), values))
        for i in range(microbatches):
            loss, grads = single(values, _rows(batch, i * n, (i + 1) * n))
            loss_sum = loss_sum + loss
            grads_sum = optim.tree_map(torch.add, grads_sum, grads)
            del grads
        inv = 1.0 / microbatches
        return loss_sum * inv, optim.tree_map(lambda g: g * inv, grads_sum)

    return accumulated


def make_train_step(loss_fn, tcfg: TrainConfig, rules=None, mesh=None,
                    param_axes=None):
    """loss_fn(values, batch) -> scalar.  Returns (train_step, opt_init);
    ``train_step(values, opt_state, batch, step)`` -> (values, opt_state,
    {"loss", "grad_norm", "lr"}), nothing updated in place."""
    del rules, mesh, param_axes
    opt_cfg = optim.AdamWConfig(lr=tcfg.lr, b1=tcfg.b1, b2=tcfg.b2,
                                weight_decay=tcfg.weight_decay)
    sched = optim.linear_warmup_cosine(tcfg.lr, tcfg.warmup_steps,
                                       tcfg.total_steps)
    eff_loss = loss_fn
    if tcfg.cast_params_bf16:
        def eff_loss(v, b):  # noqa: F811
            return loss_fn(pp.cast_tree(v, torch.bfloat16), b)

    grads_fn = make_loss_and_grads(eff_loss, tcfg.microbatches)

    def opt_init(values):
        return optim.adamw_init(values, opt_cfg)

    def train_step(values, opt_state, batch, step):
        loss, grads = grads_fn(values, batch)
        grads, grad_norm = optim.clip_by_global_norm(grads,
                                                     tcfg.max_grad_norm)
        lr = sched(step)
        new_values, new_opt = optim.adamw_update(grads, opt_state, values,
                                                 opt_cfg, lr)
        return new_values, new_opt, {"loss": loss, "grad_norm": grad_norm,
                                     "lr": lr}

    return train_step, opt_init
