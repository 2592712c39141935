"""Model-zoo dispatch (``repro.models.lm``): one interface over every
family of the configs: dense, MoE, SSM (Mamba-2), hybrid, the prefix VLM
and the encoder-decoder.

``build(cfg)`` returns a ``ModelAPI`` with
  init(key, dtype=float32) -> values     (concrete params on the device)
  abstract() -> (values, axes)           (the same tree on the meta device)
  loss_fn(values, batch, key) -> scalar  (next-token CE with a z-loss)
  prefill_fn(values, batch, max_seq) -> (logits, caches)
      (the encoder-decoder's: prefill_fn(values, batch) ->
       (logits, (enc_out, cross_k, cross_v)), as the reference's)
  decode_fn(values, caches, token, pos) -> (logits, caches)
  decode_cache_specs(batch, seq) -> caches on the meta device
  decode_cache_axes(batch, seq) / input_specs(shape) / input_axes()

The attention route is fixed where the model is built.  By default
prefill self-attention goes through ``kernels/ops.flash_attention``: on a
CUDA tensor it launches ``csrc/flash_attention.cu``, on a CPU tensor it
runs ``flash_attention_plain``.  A plain build passes
``attention=flash_attention_plain``.  Nothing falls back at run time.
The kernel has no backward, and on the card its wrapper raises for an
input that requires grad, so training builds with
``attention=attention.attend_causal`` (``attend_chunked``, the
reference's training route; ``launch/train.py``).
The kernel takes a head_dim that is a multiple of 16 up to 256
(gemma3-12b's and paligemma-3b's 256 included); on the card, ``build``
raises ``NotImplementedError`` for a config beyond that unless the caller
passes an attention function.  ``api.attention`` names the route; the
SSM family (mamba2-780m) has no attention layer, so its route is named
but never called, and its head_dim (d_model / n_heads) is not checked.
The VLM's layers carry the prefix mask, so its prefill attention goes
through ``attend_chunked`` and its route is never called either; the
encoder-decoder's route takes the decoder's causal self-attention in
``decode_train`` (``models/encdec.py``).  Decode attends over the caches
with ``attention.decode_attend``, as the reference does.

Batch layouts, as the reference's:
  dense/moe/ssm/hybrid : {"tokens": (B, S)}
  vlm                  : + {"img_embeds": (B, prefix, D)}   (SigLIP stub)
  encdec               : {"frames": (B, S_enc, D), "tokens": (B, S)}
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
from . import encdec as encdec_lib
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
                f"{FA.MAX_HEAD_DIM})")
        attention = ops.flash_attention
    return attention, getattr(attention, "__name__", repr(attention))


def _tokens(batch: Dict[str, Any], dev) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"], device=dev).long()


def _embeds(batch: Dict[str, Any], name: str, dev):
    """``batch[name]`` (img_embeds or frames) on the device, or None."""
    x = batch.get(name)
    return None if x is None else torch.as_tensor(x, device=dev)


def _batch_axes(cfg: ModelConfig) -> Dict[str, Any]:
    axes: Dict[str, Any] = {"tokens": ("batch", None)}
    if cfg.family == "vlm":
        axes["img_embeds"] = ("batch", None, None)
    if cfg.family == "encdec":
        axes["frames"] = ("batch", None, None)
    return axes


def _token_specs(cfg: ModelConfig, shape: ShapeCell) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
    if cfg.family == "vlm":
        specs["img_embeds"] = torch.empty((B, cfg.prefix_tokens, cfg.d_model),
                                          dtype=torch.bfloat16, device="meta")
    if cfg.family == "encdec":
        specs["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                      dtype=torch.bfloat16, device="meta")
    return specs


def build(cfg: ModelConfig, remat_policy: Optional[str] = "full",
          attention: Optional[Callable] = None,
          device=None) -> ModelAPI:
    """The model's API on ``device`` (the GPU unless ``device="cpu"``)
    with prefill attention ``attention(q, k, v, window, softcap)`` (default
    the flash kernel, see the module docstring)."""
    dev = resolve_device(device)
    attend, route = _route(cfg, attention, dev)
    if cfg.family == "encdec":
        return _build_encdec(cfg, remat_policy, attend, route, dev)
    tfm.require_decoder(cfg)

    def init(key, dtype=torch.float32):
        return tfm.model_init(key, cfg, dtype, dev)[0]

    def abstract():
        return tfm.model_init(torch.zeros(2, dtype=torch.int64), cfg,
                              device="meta")

    def forward_logits(values, batch, remat=None):
        return tfm.forward(values, cfg, _tokens(batch, dev), attend,
                           img_embeds=_embeds(batch, "img_embeds", dev),
                           remat_policy=remat)

    def loss_fn(values, batch, key=None):
        tokens = _tokens(batch, dev)
        logits, _ = forward_logits(values, batch, remat_policy)
        # predict token t+1 from the prefix up to t; the VLM's image
        # prefix positions predict nothing
        pred = logits[:, cfg.prefix_tokens:][:, :-1]
        return cross_entropy(pred, tokens[:, 1:])

    def prefill_fn(values, batch, max_seq=None):
        return tfm.prefill(values, cfg, _tokens(batch, dev), attend,
                           img_embeds=_embeds(batch, "img_embeds", dev),
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

    return ModelAPI(cfg, init, abstract, loss_fn, prefill_fn, decode_fn,
                    decode_cache_specs, decode_cache_axes,
                    lambda shape: _token_specs(cfg, shape),
                    lambda: _batch_axes(cfg), dev, route)


def _build_encdec(cfg: ModelConfig, remat_policy, attend: Callable,
                  route: str, dev: torch.device) -> ModelAPI:
    """The encoder-decoder's API (``repro.models.lm._build_encdec``):
    ``prefill_fn(values, batch)`` takes no ``max_seq`` and returns
    ``(logits, (enc_out, cross_k, cross_v))``; ``decode_fn`` steps an
    ``encdec.EncDecCache``.  The decoder's causal self-attention in
    ``decode_train`` goes through ``attend``."""

    def init(key, dtype=torch.float32):
        return encdec_lib.model_init(key, cfg, dtype, dev)[0]

    def abstract():
        return encdec_lib.abstract_params(cfg)

    def loss_fn(values, batch, key=None):
        tokens = _tokens(batch, dev)
        enc_out = encdec_lib.encode(values, cfg, _embeds(batch, "frames", dev))
        logits = encdec_lib.decode_train(values, cfg, tokens, enc_out, attend,
                                         remat_policy)
        return cross_entropy(logits[:, :-1], tokens[:, 1:])

    def prefill_fn(values, batch):
        enc_out = encdec_lib.encode(values, cfg, _embeds(batch, "frames", dev))
        logits = encdec_lib.decode_train(values, cfg, _tokens(batch, dev),
                                         enc_out, attend)
        ck, cv = encdec_lib.prefill_cross(values, cfg, enc_out)
        return logits, (enc_out, ck, cv)

    def decode_fn(values, cache, token, pos):
        return encdec_lib.decode_step(values, cfg, cache,
                                      torch.as_tensor(token, device=dev).long(),
                                      int(pos))

    def decode_cache_specs(batch: int, seq: int, dtype=torch.bfloat16):
        return encdec_lib.init_cache(cfg, batch, seq, dtype, device="meta")

    def decode_cache_axes(batch: int, seq: int):
        ax = Axes((None,) + tuple(KV_AXES))   # + the stacked-layer dim
        return encdec_lib.EncDecCache(ax, ax, ax, ax)

    return ModelAPI(cfg, init, abstract, loss_fn, prefill_fn, decode_fn,
                    decode_cache_specs, decode_cache_axes,
                    lambda shape: _token_specs(cfg, shape),
                    lambda: _batch_axes(cfg), dev, route)
