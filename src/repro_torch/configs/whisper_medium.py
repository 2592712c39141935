"""whisper-medium [audio] — enc-dec, 24L each, d1024 16H d_ff 4096
vocab 51865.  Conv audio frontend STUBBED per task spec: input_specs()
provides 1500 precomputed frame embeddings (30 s @ 50 Hz post-conv)
[arXiv:2212.04356].  Note: the real model caps decoder context at 448;
the assigned decode_32k/train_4k shapes exercise the backbone beyond that
(documented in DESIGN.md)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51865,
    is_encoder_decoder=True, encoder_layers=24, encoder_seq=1500,
    act="gelu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
    is_encoder_decoder=True, encoder_layers=2, encoder_seq=16,
    act="gelu", tie_embeddings=True,
)
