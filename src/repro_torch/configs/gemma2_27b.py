"""gemma2-27b's attention widths (``repro/configs/gemma2_27b.py``): 32
query heads over 16 KV heads (GQA), head_dim 128, local layers with a
4,096-token sliding window, attention logits softcapped at 50
[arXiv:2408.00118].  Only the fields the flash-attention kernel reads are
copied; the rest of the LM stays with the reference.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    name: str
    n_heads: int
    n_kv_heads: int
    head_dim: int
    window: int           # of the local layers; global layers use 0
    attn_softcap: float


CONFIG = AttentionConfig(name="gemma2-27b", n_heads=32, n_kv_heads=16,
                         head_dim=128, window=4096, attn_softcap=50.0)

SMOKE = AttentionConfig(name="gemma2-smoke", n_heads=4, n_kv_heads=2,
                        head_dim=16, window=8, attn_softcap=50.0)
