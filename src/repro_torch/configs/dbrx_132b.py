"""dbrx-132b [moe] — 40L d6144 48H (GQA kv=8) vocab 100352, 16 experts
top-4 with per-expert d_ff 10752 (fine-grained) [hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352,
    n_experts=16, top_k=4, moe_d_ff=10752,
    act="silu", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="dbrx-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=512,
    n_experts=4, top_k=2, moe_d_ff=96, moe_group_size=64,
    act="silu", tie_embeddings=False,
)
