"""Config dataclasses + the assigned input-shape sets."""
from __future__ import annotations

import dataclasses
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 256
    # --- attention variants ---
    sliding_window: int = 0  # 0 = full attention
    local_global_ratio: int = 0  # N -> N local layers per 1 global (gemma3: 5)
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    global_rope_theta: float = 0.0  # gemma3: different theta on global layers
    # --- hybrid (zamba2) ---
    attn_every: int = 0  # apply the *shared* attention block after every k SSM layers
    # --- encoder-decoder (seamless) ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    target_ratio: int = 8  # target_len = seq_len // target_ratio for enc-dec shapes
    # --- frontend stubs ---
    input_is_embeddings: bool = False  # [audio]: precomputed frame embeddings
    # --- numerics / memory ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    remat: bool = True  # checkpoint each scanned layer in train_step
    # --- perf-iteration knobs (EXPERIMENTS.md §Perf) ---
    attn_layout: str = "batch_full"  # train attention: batch_full | sp
    mamba_layout: str = "head_tp"  # mamba mixer: head_tp | seq_sp
    embed_gather: str = "auto"  # auto (GSPMD) | shard_map (local+psum)
    loss_chunk: int = 0  # >0: compute CE over seq chunks (no full logits)
    zero1: bool = False  # shard optimizer moments over the data axis
    zero3: bool = False  # FSDP: shard params (+grads) over the data axis too
    ssd_bf16: bool = False  # bf16 SSD intra-chunk intermediates (mamba2)
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards on a 16-way axis."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic (or windowed-KV) archs that run the long_500k shape."""
        return self.family in ("ssm", "hybrid") or self.local_global_ratio > 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """The shape cells this arch runs (long_500k only for sub-quadratic)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        out.append("long_500k")
    return tuple(out)
