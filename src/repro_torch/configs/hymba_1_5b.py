"""hymba-1.5b [hybrid] — 32L d1600 25H (GQA kv=5, head_dim 64) d_ff 5504
vocab 32001, parallel attention + mamba heads in every layer (ssm_state 16),
sliding-window attention except first/middle/last global layers
[arXiv:2411.13676].  (Meta-tokens omitted — noted in DESIGN.md.)"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    window=1024, local_global_pattern="ends_global",
    parallel_ssm=True,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    act="silu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    window=8, local_global_pattern="ends_global",
    parallel_ssm=True,
    ssm_state=8, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16,
    act="silu", tie_embeddings=True,
)
