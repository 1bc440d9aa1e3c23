"""Plain PyTorch versions of the hand-written kernels (the correctness
contracts).  Each mirrors its counterpart in the reference package's
``kernels/ref.py``; every index is clamped explicitly where XLA would clamp
it implicitly, so the results match bit for bit on any input."""
from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[...] = table[idx[...]] for an index of any shape (output
    ``idx.shape + (D,)``); idx < 0 yields zeros (cache-miss slots), idx >= N
    reads row N - 1 (XLA's clamp)."""
    safe = idx.to(torch.int64).clamp(0, table.shape[0] - 1)
    out = table.index_select(0, safe.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(table.shape[1:]))
    return torch.where((idx >= 0)[..., None], out, 0).to(table.dtype)


def scatter_rows(table: torch.Tensor, idx: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """out = table; out[idx[i]] = rows[i] for idx[i] in [0, N) — functional
    (the input table is untouched); negatives/out-of-range are dropped.
    Valid indices must be unique (cache slots freed by one refresh are)."""
    N = table.shape[0]
    idx = idx.reshape(-1).to(torch.int64)
    valid = (idx >= 0) & (idx < N)
    return table.index_copy(0, idx[valid], rows[valid].to(table.dtype))


def fused_gather_overlay(table: torch.Tensor, idx: torch.Tensor,
                         miss_rows: torch.Tensor,
                         miss_inv: torch.Tensor) -> torch.Tensor:
    """One batch's unique-vertex feature block from two sources:
    ``out[i] = miss_rows[miss_inv[i]]`` where ``miss_inv[i] >= 0``, else
    ``table[idx[i]]`` where ``idx[i] >= 0``, else zeros (bucket padding).
    The two maps are disjoint by construction; miss wins on overlap."""
    cached = gather_rows(table, idx)
    fresh = miss_inv >= 0
    safe = miss_inv.to(torch.int64).clamp(0, miss_rows.shape[0] - 1)
    staged = miss_rows.index_select(0, safe).to(table.dtype)
    return torch.where(fresh[:, None], staged, cached)


def routed_gather_dense(shards: torch.Tensor, owner: torch.Tensor,
                        local_slot: torch.Tensor) -> torch.Tensor:
    """The owner-routed gather over a whole shard stack (k, R, D) with
    routing of any shape S...: ``out[...] = shards[owner, local_slot]``
    (output ``S... + (D,)``), zeros where ``owner < 0`` (host-fill misses).
    An owner past k - 1 and a slot outside [0, R) are clamped, as XLA
    clamps them."""
    k, R = shards.shape[:2]
    safe_o = owner.to(torch.int64).clamp(0, k - 1)
    safe_l = local_slot.to(torch.int64).clamp(0, R - 1)
    out = shards[safe_o, safe_l]
    return torch.where((owner >= 0)[..., None], out, 0).to(shards.dtype)


def routed_neighbor_sample_dense(indptr_shards: torch.Tensor,
                                 indices_shards: torch.Tensor,
                                 owner: torch.Tensor, local: torch.Tensor,
                                 rand: torch.Tensor) -> torch.Tensor:
    """Owner-routed CSR sampling over whole sharded-CSR stacks —
    ``indptr_shards`` (k, R+1), ``indices_shards`` (k, E) — with routing of
    any shape S... and draws ``S... + (f,)``: int32 neighbor ids
    ``out[..., j] = indices[owner, start + rand[..., j] % deg]``, -1 where
    ``owner < 0`` (topology miss) or ``deg == 0`` (``host_sample_level``'s
    sentinel).  Out-of-range owners, slots and offsets clamp as XLA clamps
    them; ``%`` is the floored remainder, as in the reference."""
    k, R1 = indptr_shards.shape
    E = indices_shards.shape[1]
    safe_o = owner.to(torch.int64).clamp(0, k - 1)
    safe_l = local.to(torch.int64).clamp(0, R1 - 1)
    start = indptr_shards[safe_o, safe_l]
    deg = indptr_shards[safe_o, (safe_l + 1).clamp_max(R1 - 1)] - start
    offs = rand.to(torch.int64) % deg.clamp_min(1)[..., None]
    idx = (start[..., None] + offs).clamp(0, E - 1)
    out = indices_shards[safe_o[..., None], idx].to(torch.int32)
    ok = (owner >= 0) & (deg > 0)
    return torch.where(ok[..., None], out, -1)
