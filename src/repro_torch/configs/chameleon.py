"""chameleon-34b [arXiv:2405.09818; unverified] — early-fusion VLM.
48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (text + VQ image
tokens share one early-fusion vocabulary; the image tokenizer is a stub —
inputs are token ids).  qk-norm as in the paper."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=65536, qk_norm=True,
)

SMOKE = ModelConfig(
    name="chameleon-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, qk_norm=True, remat=False,
)
