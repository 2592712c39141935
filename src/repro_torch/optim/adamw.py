"""AdamW with an optional float32 master copy (``repro.optim.adamw``).

Params, grads and the state's ``m``, ``v`` and ``master`` are trees of
tensors: dicts (walked in sorted key order, as ``jax.tree`` walks them),
lists and tuples.  The update is the reference's formula op for op,
``p32 - (lr*(m/c1)/(sqrt(v/c2)+eps) + lr*wd*p32)`` with the bias
corrections ``c1``, ``c2`` float32 tensors on the params' device;
``torch.optim.AdamW`` orders these operations otherwise.  A divisor is
never a host scalar, since on the GPU torch turns division by one into
a multiplication by its reciprocal.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3                 # used if no lr is passed to the update
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    use_master: bool = False         # keep a float32 master copy of params


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same places of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    leaf = tree_leaves(params)[0]
    state = {"m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
             "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
             "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}
    if cfg.use_master:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float):
    """(grads scaled so their global norm is at most ``max_norm``, norm)."""
    norm = global_norm(grads)
    # a true division: ``float / tensor`` is a reciprocal times the float
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(grads: Any, state: dict, params: Any, cfg: AdamWConfig,
                 lr: Optional[torch.Tensor] = None):
    """One AdamW step.  Returns (new_params, new_state); nothing is updated
    in place."""
    lr = cfg.lr if lr is None else lr
    count = state["count"] + 1
    c1 = 1.0 - cfg.b1 ** count.to(torch.float32)
    c2 = 1.0 - cfg.b2 ** count.to(torch.float32)

    new_m = tree_map(lambda m, g: cfg.b1 * m + (1.0 - cfg.b1) * g.float(),
                     state["m"], grads)
    new_v = tree_map(
        lambda v, g: cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g.float()),
        state["v"], grads)

    def upd_p(p, m, v):
        p32 = p.to(torch.float32)
        step = lr * (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        step = step + lr * cfg.weight_decay * p32
        return p32 - step

    new_master = tree_map(upd_p, state.get("master", params), new_m, new_v)
    new_params = tree_map(lambda nm, p: nm.to(p.dtype), new_master, params)
    new_state = {"m": new_m, "v": new_v, "count": count}
    if cfg.use_master:
        new_state["master"] = new_master
    return new_params, new_state
