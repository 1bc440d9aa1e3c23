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


def routed_neighbor_sample_chain(indptr_shards: torch.Tensor,
                                 indices_shards: torch.Tensor,
                                 topo_owner: torch.Tensor,
                                 topo_local: torch.Tensor, seeds: torch.Tensor,
                                 rands) -> tuple:
    """A whole device-sampling chain over the sharded topology cache: per
    hop, the routing glue of ``CliqueCache.device_sample_cached`` (sharded
    mode) composed with ``routed_neighbor_sample_dense``, hop ``k + 1``
    sampling from hop ``k``'s flattened output.

    A frontier vertex below 0 (a padded seed, a -1 parent) is a miss, as is
    one whose ``topo_owner`` is below 0 (uncached); a vertex past the end
    of the routing tables reads the last entry and a slot is clamped into
    the owner's rows before the int32 cast, as XLA clamps them.  Returns
    (per-hop neighbors ``(n_k, f_k)`` int32, per-hop hit masks ``(n_k,)``
    bool), ``n_0 = len(seeds)`` and ``n_{k+1} = n_k * f_k``."""
    R1 = indptr_shards.shape[1]
    N = topo_owner.shape[0]
    outs, hits = [], []
    frontier = seeds.to(torch.int64)
    for rand in rands:
        valid = frontier >= 0
        safe = torch.where(valid, frontier, 0).clamp_max(N - 1)
        owner = torch.where(valid, topo_owner[safe], -1)
        local = topo_local[safe].clamp(0, R1 - 1).to(torch.int32)
        out = routed_neighbor_sample_dense(indptr_shards, indices_shards,
                                           owner, local, rand)
        outs.append(out)
        hits.append(owner >= 0)
        frontier = out.reshape(-1).to(torch.int64)
    return outs, hits


def _take(t: torch.Tensor, idx: torch.Tensor, device) -> torch.Tensor:
    """``t.index_select(0, idx)`` read where ``t`` lives (a shard may lie on
    a peer card) and returned on ``device``."""
    return t.index_select(0, idx.to(t.device)).to(device)


def _check_peer_shards(shards, what: str) -> None:
    if not len(shards) or any(s.shape != shards[0].shape
                              or s.dtype != shards[0].dtype for s in shards):
        raise ValueError(f"{what}: need one or more shards of one shape and "
                         "type")


def routed_gather_peer(shards, owner: torch.Tensor,
                       local_slot: torch.Tensor) -> torch.Tensor:
    """``routed_gather_dense`` over the clique's shards as separate tensors
    (each (R, D), of one shape and type, possibly on different devices):
    ``out[...] = shards[owner][local_slot]`` on the routing's device, zeros
    where ``owner < 0``, owners and slots clamped as the dense form clamps
    them.  Bit for bit ``routed_gather_dense(torch.stack(shards), ...)``."""
    _check_peer_shards(shards, "routed_gather_peer")
    k, (R, D) = len(shards), shards[0].shape
    dev = owner.device
    o = owner.reshape(-1).to(torch.int64).clamp(0, k - 1)
    sl = local_slot.reshape(-1).to(torch.int64).clamp(0, R - 1)
    out = torch.empty((o.shape[0], D), dtype=shards[0].dtype, device=dev)
    for gi, s in enumerate(shards):
        rows = torch.nonzero(o == gi).reshape(-1)
        out[rows] = _take(s, sl[rows], dev)
    out = out.reshape(tuple(owner.shape) + (D,))
    return torch.where((owner >= 0)[..., None], out, 0).to(shards[0].dtype)


def _peer_rows(indptr_shards, owner, local):
    """Each row's clamped owner, CSR start and degree, read from its
    owner's indptr shard."""
    k, R1 = len(indptr_shards), indptr_shards[0].shape[0]
    dev = owner.device
    o = owner.to(torch.int64).clamp(0, k - 1)
    lo = local.to(torch.int64).clamp(0, R1 - 1)
    l1 = (lo + 1).clamp_max(R1 - 1)
    start = torch.zeros_like(lo)
    end = torch.zeros_like(lo)
    for gi, ip in enumerate(indptr_shards):
        rows = torch.nonzero(o == gi).reshape(-1)
        start[rows] = _take(ip, lo[rows], dev)
        end[rows] = _take(ip, l1[rows], dev)
    return o, start, end - start


def routed_neighbor_sample_peer(indptr_shards, indices_shards,
                                owner: torch.Tensor, local: torch.Tensor,
                                rand: torch.Tensor) -> torch.Tensor:
    """``routed_neighbor_sample_dense`` over the clique's CSR shards as
    separate tensors (``indptr_shards[gi]`` (R+1,) int64 and
    ``indices_shards[gi]`` (E,) int32, each list of one shape, possibly on
    different devices), for routing (n,) and draws (n, f) on one device:
    int32 neighbor ids on that device, -1 at misses and degree 0, every
    clamp the dense form's.  Bit for bit the dense form over
    ``torch.stack`` of the same shards."""
    _check_peer_shards(indptr_shards, "routed_neighbor_sample_peer")
    _check_peer_shards(indices_shards, "routed_neighbor_sample_peer")
    if len(indptr_shards) != len(indices_shards):
        raise ValueError("routed_neighbor_sample_peer: indptr and indices "
                         "shards differ in number")
    E = indices_shards[0].shape[0]
    dev = owner.device
    o, start, deg = _peer_rows(indptr_shards, owner, local)
    offs = rand.to(torch.int64) % deg.clamp_min(1)[:, None]
    idx = (start[:, None] + offs).clamp(0, E - 1)
    out = torch.empty(idx.shape, dtype=torch.int32, device=dev)
    for gi, ix in enumerate(indices_shards):
        rows = torch.nonzero(o == gi).reshape(-1)
        out[rows] = _take(ix, idx[rows].reshape(-1), dev).reshape(
            -1, idx.shape[1]).to(torch.int32)
    ok = (owner >= 0) & (deg > 0)
    return torch.where(ok[:, None], out, -1)


def routed_neighbor_sample_chain_peer(indptr_shards, indices_shards,
                                      topo_owner: torch.Tensor,
                                      topo_local: torch.Tensor,
                                      seeds: torch.Tensor, rands) -> tuple:
    """``routed_neighbor_sample_chain`` over separate CSR shards (as for
    ``routed_neighbor_sample_peer``), the routing tables and the seeds on
    the sampling position's device: the same glue, hop ``k + 1`` sampling
    from hop ``k``'s flattened output with the peer form.  Bit for bit the
    dense chain over ``torch.stack`` of the same shards."""
    R1 = indptr_shards[0].shape[0]
    N = topo_owner.shape[0]
    outs, hits = [], []
    frontier = seeds.to(torch.int64)
    for rand in rands:
        valid = frontier >= 0
        safe = torch.where(valid, frontier, 0).clamp_max(N - 1)
        owner = torch.where(valid, topo_owner[safe], -1)
        local = topo_local[safe].clamp(0, R1 - 1).to(torch.int32)
        out = routed_neighbor_sample_peer(indptr_shards, indices_shards,
                                          owner, local, rand)
        outs.append(out)
        hits.append(owner >= 0)
        frontier = out.reshape(-1).to(torch.int64)
    return outs, hits


NEG_INF = -1e30  # the reference's masked score


def attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
              window: int = 0, k_valid=None) -> torch.Tensor:
    """(…, Sq, Sk) boolean mask from absolute positions (the reference's
    ``layers._attn_mask``); ``window <= 0`` means unbounded."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= qp >= kp
    if window > 0:
        m &= qp - kp < window
    if k_valid is not None:
        m &= k_valid[..., None, :]
    return m


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_kv: int = 1024, return_lse: bool = False,
                    q_offset: int = 0, kv_offset: int = 0):
    """Chunked online-softmax attention with GQA, as the reference's LM path
    computes it (``models/layers.py`` ``flash_attention``).

    q (B, Sq, Hq, Dh), k and v (B, Sk, Hkv, Dh); or the Pallas kernel's
    (BH, S, Dh), which is the case B = BH, Hq = Hkv = 1.  Query head ``h``
    reads kv head ``h // (Hq // Hkv)``; query ``i`` sits at position
    ``q_offset + i`` and key ``j`` at ``kv_offset + j`` (the reference's
    offsets: the mask compares positions).  Keys are padded to a multiple of
    ``block_kv`` and visited block by block; ``q * scale`` is rounded to the
    input type (jnp's weakly typed scalar is the input type, so the scale
    is rounded too), scores and running statistics are f32, ``p`` is
    rounded to the value type before ``p @ v``, and masked scores are
    ``NEG_INF``.

    With ``return_lse`` it returns ``(out, lse)``: each row's log-sum-exp of
    its masked scores, (B, Hq, Sq) f32 (or (BH, S) for the 3-D contract),
    in natural log, ``m + log(l)`` from the same running max ``m`` and sum
    ``l`` the loop keeps (the kernels write the same convention).  It is
    what ``flash_attention_bwd`` recomputes p from."""
    if q.dim() == 3:
        out = flash_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                              causal=causal, window=window,
                              block_kv=block_kv, return_lse=return_lse,
                              q_offset=q_offset, kv_offset=kv_offset)
        if return_lse:
            return out[0][:, :, 0], out[1][:, 0]
        return out[:, :, 0]
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    scale = torch.full((), Dh ** -0.5, dtype=q.dtype, device=dev)
    block = min(block_kv, Sk)
    pad = (-Sk) % block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qg = (q.reshape(B, Sq, Hkv, G, Dh) * scale).float()
    q_pos = q_offset + torch.arange(Sq, device=dev)
    o = torch.zeros((B, Hkv, G, Sq, Dh), dtype=torch.float32, device=dev)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    for b0 in range(0, Sk + pad, block):
        kb, vb = k[:, b0:b0 + block], v[:, b0:b0 + block]
        j = torch.arange(b0, b0 + block, device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb.float())
        mask = attn_mask(q_pos, kv_offset + j, causal=causal, window=window,
                         k_valid=j < Sk)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    o = o / l.clamp_min(1e-30)[..., None]
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l)).reshape(B, Hq, Sq).contiguous()
    return o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        block_kv: int = 1024, q_offset: int = 0,
                        kv_offset: int = 0) -> tuple:
    """The gradient of ``flash_attention`` as the backward kernel computes
    it: (dq, dk, dv) in the input type, from q, k, v, the forward's output
    ``o``, its log-sum-exp ``lse`` (B, Hq, Sq) (natural log, as
    ``flash_attention(..., return_lse=True)`` gives it) and the output's
    gradient ``do`` (B, Sq, Hq, Dh).  Query ``i`` and key ``j`` sit at
    ``q_offset + i`` and ``kv_offset + j``, as in the forward (a mesh
    position's sequence block: dk and dv are then that block's share of
    the keys' gradient).

    Key block by key block (``block_kv`` keys): p = exp(s - lse) from the
    recomputed masked scores s = bf16(q * scale) . k (0 where masked);
    D = rowsum(do * o) in f32; dv = p^T do and dp = do v^T; ds = p * (dp -
    D); dk = ds^T bf16(q * scale) and dq = ds k * scale, summed in f32 over
    the blocks.  dk and dv sum over the G query heads of each kv head.

    Rounding points, those of autograd through ``flash_attention``: q *
    scale rounded to the input type (the scale itself rounded too), p
    rounded to the value type before p^T do (the forward's p . v), o and do
    in the input type (the output cast); dq, dk and dv are each rounded to
    the input type once, at the end.  Everything else is f32 (for their
    products the kernel's bf16 routes, ``wgmma`` and ``mma_sync``, both take
    ds as two bf16 parts, hi = bf16(ds) and lo = bf16(ds - hi)).  In f32
    none of these rounds (the kernel's ``simt`` route keeps every value in
    f32 too)."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    scale = torch.full((), Dh ** -0.5, dtype=q.dtype, device=dev)
    qs = (q.reshape(B, Sq, Hkv, G, Dh) * scale).float()
    dof = do.reshape(B, Sq, Hkv, G, Dh).float()
    delta = (dof * o.reshape(B, Sq, Hkv, G, Dh).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1)  # (B, Hkv, G, Sq)
    lse = lse.reshape(B, Hkv, G, Sq).float()
    q_pos = q_offset + torch.arange(Sq, device=dev)
    dqs = torch.zeros((B, Sq, Hkv, G, Dh), dtype=torch.float32, device=dev)
    dk = torch.empty((B, Sk, Hkv, Dh), dtype=k.dtype, device=dev)
    dv = torch.empty((B, Sk, Hkv, Dh), dtype=v.dtype, device=dev)
    for b0 in range(0, Sk, block_kv):
        kb = k[:, b0:b0 + block_kv].float()
        vb = v[:, b0:b0 + block_kv]
        j = kv_offset + torch.arange(b0, b0 + kb.shape[1], device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qs, kb)
        mask = attn_mask(q_pos, j, causal=causal, window=window)
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        dv[:, b0:b0 + block_kv] = torch.einsum(
            "bhgqk,bqhgd->bkhd", p.to(v.dtype).float(), dof).to(v.dtype)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vb.float())
        ds = p * (dp - delta[..., None])
        dk[:, b0:b0 + block_kv] = torch.einsum(
            "bhgqk,bqhgd->bkhd", ds, qs).to(k.dtype)
        dqs += torch.einsum("bhgqk,bkhd->bqhgd", ds, kb)
    dq = (dqs * scale.float()).to(q.dtype).reshape(B, Sq, Hq, Dh)
    return dq, dk, dv


def sage_aggregate(table: torch.Tensor, idx: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Fused gather + weighted sum: ``out[b] = Σ_f w[b, f] · table[idx[b, f]]``
    with f32 accumulation in the order f = 0, 1, …, one rounded multiply and
    one rounded add per term (as the Pallas kernel accumulates), pads
    (idx < 0) weighted 0, indices past the end clamped to the last row,
    output cast to the table's type."""
    N = table.shape[0]
    safe = idx.to(torch.int64).clamp(0, N - 1)
    w = torch.where(idx >= 0, weights.float(), 0.0)
    acc = torch.zeros((idx.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for f in range(idx.shape[1]):
        acc = acc + table.index_select(0, safe[:, f]).float() * w[:, f, None]
    return acc.to(table.dtype)
