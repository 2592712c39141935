"""gemma3-12b [dense] — 48L d3840 16H (GQA kv=8, head_dim 256) d_ff 15360
vocab 262144.  5:1 local:global (window 1024), qk-norm, 128k context
[hf:google/gemma-3-12b-pt]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144,
    window=1024, local_global_pattern="five_to_one",
    qk_norm=True, post_norms=True, rope_theta=1e6,
    act="geglu", embed_scale=True, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    window=8, local_global_pattern="five_to_one",
    qk_norm=True, post_norms=True, rope_theta=1e6,
    act="geglu", embed_scale=True, tie_embeddings=True,
)
