"""qwen2.5-14b [hf:Qwen/Qwen2.5-0.5B; hf]
48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064, qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen25-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, qkv_bias=True, remat=False,
)
