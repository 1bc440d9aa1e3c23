"""mamba2-780m [arXiv:2405.21060; unverified] — SSD (state-space duality).
48L d_model=1536 (attention-free) vocab=50280, ssm_state=128;
d_inner = 2*d_model = 3072, headdim 64 -> 48 SSD heads."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2,
    notes="attention-free; O(1) decode state; runs long_500k.",
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=512,
    ssm_state=16, ssm_headdim=16, ssm_expand=2, ssd_chunk=16, remat=False,
)
