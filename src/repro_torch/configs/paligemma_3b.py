"""paligemma-3b [vlm] — 18L d2048 8H (MQA kv=1, head_dim 256) d_ff 16384
vocab 257216.  SigLIP vision tower STUBBED per task spec: input_specs()
provides 256 precomputed patch embeddings; the text backbone attends to
them as a bidirectional prefix (prefix-LM mask) [arXiv:2407.07726]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216,
    prefix_tokens=256,
    act="geglu", embed_scale=True, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="paligemma-smoke", family="vlm",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512,
    prefix_tokens=8,
    act="geglu", embed_scale=True, tie_embeddings=True,
)
