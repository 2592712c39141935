"""minitron-8b [dense] — 32L d4096 32H (GQA kv=8) d_ff 16384 vocab 256000.
Width/depth-pruned nemotron [arXiv:2407.14679]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=256000,
    act="silu", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="minitron-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    act="silu", tie_embeddings=False,
)
