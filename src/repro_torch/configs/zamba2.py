"""zamba2-1.2b [arXiv:2411.15242; hf]
hybrid: 38 Mamba2 layers (d_model=2048, ssm_state=64) + a *shared* attention
block (32H GQA kv=32, d_ff=8192) applied after every 6 SSM layers.
vocab 32000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, attn_every=6,
    notes="Mamba2 backbone + shared attn blocks; runs long_500k.",
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    ssm_state=16, ssm_headdim=16, ssm_expand=2, attn_every=2, ssd_chunk=16,
    remat=False,
)
