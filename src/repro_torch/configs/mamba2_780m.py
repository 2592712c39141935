"""mamba2-780m [ssm] — 48L d1536 attention-free, vocab 50280,
SSD state 128, head_dim 64, expand 2 (d_inner 3072, 48 SSM heads)
[arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=3, d_model=64, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=512,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16,
    tie_embeddings=True,
)
