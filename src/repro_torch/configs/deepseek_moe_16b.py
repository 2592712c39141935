"""deepseek-moe-16b [moe] — 28L d2048 16H (MHA kv=16) vocab 102400,
64 routed experts top-6 + 2 shared experts, fine-grained d_ff 1408
[arXiv:2401.06066].  (The real model's first layer is a dense FFN; we keep
all layers MoE for scan homogeneity — noted in DESIGN.md.)"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
    act="silu", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=48, vocab=512,
    n_experts=8, top_k=2, n_shared_experts=2, moe_d_ff=48, moe_group_size=64,
    act="silu", tie_embeddings=False,
)
