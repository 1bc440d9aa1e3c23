"""seamless-m4t-large-v2 [arXiv:2308.11596; hf]
enc-dec, 24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.
Backbone only: the audio frontend is a stub (precomputed frame embeddings).
"24L" is read as 24 encoder + 24 decoder layers (the large-v2 text decoder
and speech encoder are both 24 layers)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206,
    n_enc_layers=24, n_dec_layers=24, input_is_embeddings=True,
    notes="encoder-decoder; frontend stubbed with frame embeddings.",
)

SMOKE = ModelConfig(
    name="seamless-smoke", family="audio",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, n_enc_layers=2, n_dec_layers=2,
    input_is_embeddings=True, remat=False,
)
