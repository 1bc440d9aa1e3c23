"""minitron-4b [arXiv:2407.14679; hf] — pruned nemotron.
32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab_size=256000,
)

SMOKE = ModelConfig(
    name="minitron-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, remat=False,
)
