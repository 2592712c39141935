"""Model configuration shared by every assigned architecture.

One dataclass covers the whole zoo; family-specific fields are zero/None
when unused.  ``layer_kinds()`` resolves the local/global attention pattern
(gemma2's 1:1 alternation, gemma3's 5:1, hymba's first/middle/last-global)
into a per-layer window size: ``0`` means full (global) attention, else the
sliding-window width.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0            # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024

    # attention features
    qk_norm: bool = False                 # qwen3 / gemma3
    attn_softcap: float = 0.0             # gemma2: 50.0 (0 = off)
    final_softcap: float = 0.0            # gemma2: 30.0 (0 = off)
    window: int = 0                       # sliding-window width for local layers
    local_global_pattern: str = "all_global"
    #   all_global | alternating | five_to_one | ends_global
    rope_theta: float = 10000.0
    post_norms: bool = False              # gemma2/3 sandwich norms

    # ffn
    act: str = "silu"                     # silu (gated) | geglu | gelu
    tie_embeddings: bool = True
    embed_scale: bool = False             # gemma family: x *= sqrt(d_model)

    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024            # routing-group tokens (GShard-style)

    # ssm (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (hymba): parallel attention + SSM heads in each layer
    parallel_ssm: bool = False

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500               # 30 s audio @ 50 Hz post-conv (stub)

    # vlm (paligemma): image-prefix length with precomputed embeddings (stub)
    prefix_tokens: int = 0

    norm_eps: float = 1e-6
    dtype: str = "bfloat16"               # activation/compute dtype

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the embedding's vocab dim divides any
        (model|data) mesh axis; unembed masks the padding to -inf."""
        return -(-self.vocab // 256) * 256

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def layer_kinds(self) -> Tuple[int, ...]:
        """Per-layer attention window (0 = global/full attention)."""
        n, w = self.n_layers, self.window
        if self.local_global_pattern == "all_global" or w == 0:
            return tuple(0 for _ in range(n))
        if self.local_global_pattern == "alternating":      # gemma2
            return tuple(w if i % 2 == 0 else 0 for i in range(n))
        if self.local_global_pattern == "five_to_one":      # gemma3
            return tuple(0 if i % 6 == 5 else w for i in range(n))
        if self.local_global_pattern == "ends_global":      # hymba
            mid = n // 2
            return tuple(0 if i in (0, mid, n - 1) else w for i in range(n))
        raise ValueError(self.local_global_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6*N*D roofline)."""
        d, v, L = self.d_model, self.vocab, self.n_layers
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family == "moe":
            ffn = 3 * d * self.moe_d_ff * (self.n_experts + self.n_shared_experts)
            ffn += d * self.n_experts  # router
        elif self.family == "ssm":
            attn = 0
            ffn = 0
        else:
            ffn = 3 * d * self.d_ff
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, ns = self.ssm_d_inner, self.ssm_state
            g = 1  # n_groups
            ssm = d * (2 * di + 2 * g * ns + self.ssm_heads) + di * d \
                + self.ssm_conv * (di + 2 * g * ns) + 2 * self.ssm_heads
        per_layer = attn + ffn + ssm + 4 * d
        if self.is_encoder_decoder:
            # whisper: non-gated GELU MLPs (2 matmuls), learned positions,
            # cross-attention per decoder layer
            ffn2 = 2 * d * self.d_ff
            dec_layer = 2 * attn + ffn2 + 6 * d
            enc_layer = attn + ffn2 + 4 * d
            total = (emb + L * dec_layer
                     + self.encoder_layers * enc_layer
                     + (self.encoder_seq + 32768) * d)  # pos embeds
            return int(total)
        total = emb + L * per_layer
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        ffn_act = 3 * d * self.moe_d_ff * (self.top_k + self.n_shared_experts)
        per_layer = attn + ffn_act + d * self.n_experts + 4 * d
        return int(emb + L * per_layer)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (shape) of the assigned grid."""
    name: str           # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str           # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}
