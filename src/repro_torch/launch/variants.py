"""Named perf-iteration variants for the dry-run (a copy of the reference's
``launch/variants.py``).

A variant is a set of ModelConfig overrides applied before building the
cell; each (cell, variant) produces its own record, so baseline and
variant roofline terms are recorded side by side.  On one card
``attn_layout``, ``embed_gather``, ``mamba_layout``, ``zero1`` and
``zero3`` change fields that nothing reads without a mesh (as in the
reference with ``mesh=None``); ``loss_chunk``, ``remat`` and ``ssd_bf16``
change the computation.
"""
from __future__ import annotations

import dataclasses

VARIANTS = {
    "baseline": {},
    # H1 (gemma3/chameleon/dense train): keep activations SP-sharded through
    # attention so the MLP stays true TP
    "sp_attn": {"attn_layout": "sp"},
    # H2 (big-vocab archs): shard_map embedding lookup (vocab-sharded grad)
    "sharded_embed": {"embed_gather": "shard_map"},
    "sp_attn+sharded_embed": {"attn_layout": "sp", "embed_gather": "shard_map"},
    # H3 (mamba2/zamba2 train): sequence-local SSD mixer
    "seq_sp_mixer": {"mamba_layout": "seq_sp"},
    "seq_sp_mixer+sharded_embed": {"mamba_layout": "seq_sp",
                                   "embed_gather": "shard_map"},
    # H4: no remat (memory-for-compute trade, where activations fit)
    # H5: chunked CE — the (B,S,V) logits never materialize
    "chunked_loss": {"loss_chunk": 512},
    "sp_attn+sharded_embed+chunked_loss": {
        "attn_layout": "sp", "embed_gather": "shard_map", "loss_chunk": 512},
    # H6: ZeRO-1 — optimizer moments sharded over the data axis
    "zero1": {"zero1": True},
    # H7: ZeRO-3/FSDP — params+grads sharded over data, gathered per layer
    "sp_attn+zero3+chunked_loss": {"attn_layout": "sp", "zero1": True,
                                   "zero3": True, "loss_chunk": 512},
    "sp_attn+zero1": {"attn_layout": "sp", "zero1": True},
    "sp_attn+zero1+chunked_loss": {"attn_layout": "sp", "zero1": True,
                                   "loss_chunk": 512},
    "seq_sp_mixer+chunked_loss": {"mamba_layout": "seq_sp", "loss_chunk": 512},
    # H8: bf16 SSD intra-chunk tensors (decays <= 1, bf16-safe)
    "seq_sp_mixer+ssd_bf16": {"mamba_layout": "seq_sp", "ssd_bf16": True},
    "seq_sp_mixer+no_remat": {"mamba_layout": "seq_sp", "remat": False},
    "no_remat": {"remat": False},
    "sp_attn+no_remat": {"attn_layout": "sp", "remat": False},
    "sp_attn+sharded_embed+no_remat": {"attn_layout": "sp",
                                       "embed_gather": "shard_map",
                                       "remat": False},
}


def apply_variant(cfg, name: str):
    over = VARIANTS[name]
    return dataclasses.replace(cfg, **over) if over else cfg
