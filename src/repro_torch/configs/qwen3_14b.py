"""qwen3-14b [dense] — 40L d5120 40H (GQA kv=8) d_ff 17408 vocab 151936.
QK-RMSNorm on attention heads [hf:Qwen/Qwen3-14B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab=151936,
    qk_norm=True, rope_theta=1e6,
    act="silu", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    qk_norm=True, rope_theta=1e6,
    act="silu", tie_embeddings=False,
)
