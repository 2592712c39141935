"""gemma2-27b [dense] — 46L d4608 32H (GQA kv=16) d_ff 36864 vocab 256000.
Local+global alternating attention (window 4096), attn/final logit
softcaps, sandwich norms, GeGLU [arXiv:2408.00118]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000,
    window=4096, local_global_pattern="alternating",
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    act="geglu", embed_scale=True, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2-smoke", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    window=8, local_global_pattern="alternating",
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    act="geglu", embed_scale=True, tie_embeddings=True,
)
