"""Model-zoo dispatch (``repro.models.lm``): one interface over the
decoder families the port has: dense, MoE, SSM (Mamba-2) and hybrid.

``build(cfg)`` returns a ``ModelAPI`` with
  init(key, dtype=float32) -> values     (concrete params on the device)
  abstract() -> (values, axes)           (the same tree on the meta device)
  loss_fn(values, batch, key) -> scalar  (next-token CE with a z-loss)
  prefill_fn(values, batch, max_seq) -> (logits, caches)
  decode_fn(values, caches, token, pos) -> (logits, caches)
  decode_cache_specs(batch, seq) -> caches on the meta device
  decode_cache_axes(batch, seq) / input_specs(shape) / input_axes()

The attention route is fixed where the model is built.  By default
prefill self-attention goes through ``kernels/ops.flash_attention``: on a
CUDA tensor it launches ``csrc/flash_attention.cu``, on a CPU tensor it
runs ``flash_attention_plain``.  A plain build passes
``attention=flash_attention_plain``.  Nothing falls back at run time.
The kernel takes a head_dim that is a multiple of 16 up to 128; on the
card, ``build`` raises ``NotImplementedError`` for a config beyond that
(gemma3-12b's 256, ROADMAP.md §1, LM item 5) unless the caller passes an
attention function.  ``api.attention`` names the route; the SSM family
(mamba2-780m) has no attention layer, so its route is named but never
called, and its head_dim (d_model / n_heads) is not checked.
Decode attends over the caches with ``attention.decode_attend``, as the
reference does.

Batch layout: {"tokens": (B, S)}.  The encoder-decoder (``_build_encdec``)
and the VLM family are not ported yet (``transformer.refuse_unported``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..device import resolve_device
from ..kernels import flash_attention as FA
from ..kernels import ops
from ..sharding.rules import Axes
from . import attention as attn_lib
from . import ssm as ssm_lib
from . import transformer as tfm
from .config import ModelConfig, ShapeCell


def cross_entropy(logits, labels, z_loss: float = 1e-4):
    """Mean next-token CE over (B, S, V) logits against (B, S) labels, plus
    ``z_loss`` times the mean squared log-normaliser."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    abstract: Callable
    loss_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    decode_cache_specs: Callable
    decode_cache_axes: Callable
    input_specs: Callable
    input_axes: Callable
    device: torch.device
    attention: str              # the prefill attention route


KV_AXES = Axes(("batch", "kv_seq", "heads_act"))
SSM_H_AXES = Axes(("batch", "heads_act", None))
SSM_CONV_AXES = Axes(("batch", None, "d_ff_act"))


def kernel_takes(cfg: ModelConfig) -> bool:
    """Whether the flash kernel takes this config's prefill attention."""
    Dh = cfg.resolved_head_dim
    return Dh % 16 == 0 and Dh <= FA.MAX_HEAD_DIM


def _route(cfg: ModelConfig, attention: Optional[Callable],
           dev: torch.device) -> tuple:
    if attention is None:
        if dev.type == "cuda" and cfg.family != "ssm" and not kernel_takes(cfg):
            raise NotImplementedError(
                f"{cfg.name}: head_dim {cfg.resolved_head_dim} is beyond "
                f"csrc/flash_attention.cu (a multiple of 16 up to "
                f"{FA.MAX_HEAD_DIM}): flash_attention.cu at head_dim 256 "
                f"(ROADMAP.md §1, LM item 5)")
        attention = ops.flash_attention
    return attention, getattr(attention, "__name__", repr(attention))


def _tokens(batch: Dict[str, Any], dev) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"], device=dev).long()


def build(cfg: ModelConfig, remat_policy: Optional[str] = "full",
          attention: Optional[Callable] = None,
          device=None) -> ModelAPI:
    """The model's API on ``device`` (the GPU unless ``device="cpu"``)
    with prefill attention ``attention(q, k, v, window, softcap)`` (default
    the flash kernel, see the module docstring)."""
    tfm.refuse_unported(cfg)
    dev = resolve_device(device)
    attend, route = _route(cfg, attention, dev)

    def init(key, dtype=torch.float32):
        return tfm.model_init(key, cfg, dtype, dev)[0]

    def abstract():
        return tfm.model_init(torch.zeros(2, dtype=torch.int64), cfg,
                              device="meta")

    def forward_logits(values, batch, remat=None):
        return tfm.forward(values, cfg, _tokens(batch, dev), attend,
                           remat_policy=remat)

    def loss_fn(values, batch, key=None):
        tokens = _tokens(batch, dev)
        logits, _ = forward_logits(values, batch, remat_policy)
        # predict token t+1 from the prefix up to t
        return cross_entropy(logits[:, :-1], tokens[:, 1:])

    def prefill_fn(values, batch, max_seq=None):
        return tfm.prefill(values, cfg, _tokens(batch, dev), attend,
                           max_seq=max_seq)

    def decode_fn(values, caches, token, pos):
        return tfm.decode_step(values, cfg, caches,
                               torch.as_tensor(token, device=dev).long(),
                               int(pos))

    def decode_cache_specs(batch: int, seq: int, dtype=torch.bfloat16):
        return tfm.init_layer_caches(cfg, batch, seq, dtype, device="meta")

    def decode_cache_axes(batch: int, seq: int):
        kv = None if cfg.family == "ssm" else attn_lib.KVCache(KV_AXES, KV_AXES)
        ssm = (ssm_lib.SSMState(SSM_H_AXES, SSM_CONV_AXES)
               if cfg.family in ("ssm", "hybrid") else None)
        return [tfm.LayerCache(kv=kv, ssm=ssm) for _ in cfg.layer_kinds()]

    def input_specs(shape: ShapeCell):
        return {"tokens": torch.empty((shape.global_batch, shape.seq_len),
                                      dtype=torch.int32, device="meta")}

    def input_axes():
        return {"tokens": ("batch", None)}

    return ModelAPI(cfg, init, abstract, loss_fn, prefill_fn, decode_fn,
                    decode_cache_specs, decode_cache_axes, input_specs,
                    input_axes, dev, route)
