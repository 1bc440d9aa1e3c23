"""gemma3-1b [hf:google/gemma-3-1b-pt; unverified]
26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144; 5 local : 1 global
sliding-window pattern (window 512), 128k-class context, qk-norm, tied
embeddings, global-layer rope theta 1e6."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    sliding_window=512, local_global_ratio=5, global_rope_theta=1_000_000.0,
    qk_norm=True, tie_embeddings=True,
    notes="sub-quadratic via 5:1 window pattern -> runs long_500k.",
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512,
    sliding_window=8, local_global_ratio=2, global_rope_theta=1_000_000.0,
    qk_norm=True, tie_embeddings=True, remat=False,
)
