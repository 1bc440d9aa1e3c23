"""Unified-cache gathers: the feature-extraction and sampling hot loops.

* ``gather_rows``: ``out[...] = table[idx[...]]``, zeros where the index is
  negative (cache misses).  The unfused finalize chain gathers a batch's
  cached rows with it (``DeviceBatchBuilder(fused=False)``).
* ``routed_gather``: the sharded executor's intra-clique exchange, one
  clique's cache shards (one tensor each, on its position's card) gathered
  by per-row (owner, local slot) routing.
* ``routed_neighbor_sample``: the sharded topology cache's routed neighbor
  exchange, fixed-fanout sampling from the owner shard's CSR.
* ``routed_neighbor_sample_chain``: every hop of one device-sampling chain
  in one launch of the same source, the routing decoded in the kernel.

On CUDA tensors each wrapper launches its hand-written Hopper kernel
(``csrc/<name>.cu``); on CPU tensors it runs the plain version in
``kernels/ref.py``.  There is no other fallback.  The routed kernels take
the clique's shards as a sequence of tensors and pass the kernel a table of
their base pointers (a shard on a peer card is read over NVLink, with peer
access enabled by ``_build.enable_peer_access``); their output lies on the
calling position's card, the routing's.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel, enable_peer_access

KERNEL = CudaKernel(
    "gather_rows", "csrc/gather_rows.cu", "gather_rows",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p])
_TABLE = ctypes.POINTER(ctypes.c_void_p)  # a host array of shard pointers
ROUTED_KERNEL = CudaKernel(
    "routed_gather", "csrc/routed_gather.cu", "routed_gather",
    [_TABLE] + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4
    + [ctypes.c_void_p])
SAMPLE_KERNEL = CudaKernel(
    "routed_neighbor_sample", "csrc/routed_neighbor_sample.cu",
    "routed_neighbor_sample",
    [_TABLE] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5
    + [ctypes.c_void_p],
    routes=("hop", "chain"),
    symbols={"routed_neighbor_sample_chain":
             [_TABLE] * 2 + [ctypes.c_void_p] * 3
             + [ctypes.POINTER(ctypes.c_void_p),
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_int32, ctypes.c_void_p,
                                      ctypes.c_void_p]
             + [ctypes.c_int64] * 5 + [ctypes.c_void_p]})
# the routed kernels' shard table (csrc/routed_gather.cu,
# routed_neighbor_sample.cu): at most this many shards, the largest NVLink
# clique of one host
MAX_SHARDS = 8
# the chain kernel's limits (csrc/routed_neighbor_sample.cu): hops, and its
# threads (up to 4 outputs of one row of the last hop each) below 2^31
MAX_CHAIN_HOPS = 4
_CHAIN_CHUNK = 4


def _device_of(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` live on: the CPU (plain version) or a
    CUDA card (the kernel); raises on mixed or other devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: all inputs must share one device, got "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    return dev


def gather_rows(table: torch.Tensor, idx: torch.Tensor, *,
                return_mask: bool = False):
    """``out[...] = table[idx[...]]`` (zeros where ``idx < 0``; indices at
    or past the end read the last row, as XLA clamps them).

    table: (N, D) with N >= 1, any element type (f32, bf16, int32 ...);
    idx: int32 of any shape B..., on the table's device.  Returns
    ``B... + (D,)``; with ``return_mask=True`` also ``idx >= 0`` (the hit
    mask the batch pipeline overlays host-fetched miss rows with).
    """
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"table must be 2-D with at least one row, got "
                         f"{tuple(table.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"table and idx must share one device, got "
                         f"{table.device} and {idx.device}")
    if table.device.type == "cpu":
        out = ref.gather_rows(table, idx)
    elif table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    else:
        if not (table.is_contiguous() and idx.is_contiguous()):
            raise ValueError("gather_rows needs contiguous inputs")
        N, D = table.shape
        out = torch.empty(tuple(idx.shape) + (D,), dtype=table.dtype,
                          device=table.device)
        fn = KERNEL.fn()
        with torch.cuda.device(table.device):
            stream = torch.cuda.current_stream(table.device).cuda_stream
            err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                     idx.numel(), N, D * table.element_size(), stream)
        KERNEL.check(err)
        KERNEL.count_launch()
    if return_mask:
        return out, idx >= 0
    return out


def _shard_list(name: str, shards, dim: int, what: str) -> list:
    """``shards`` as a list of 1 to ``MAX_SHARDS`` tensors of one shape
    (``dim`` axes, each non-empty) and type; a stacked tensor is refused:
    the kernels read each shard through its own base pointer."""
    if isinstance(shards, torch.Tensor) or not isinstance(
            shards, (list, tuple)):
        raise TypeError(f"{name}: {what} must be a sequence of shard "
                        f"tensors (one per clique position), got "
                        f"{type(shards).__name__}")
    shards = list(shards)
    if not 1 <= len(shards) <= MAX_SHARDS:
        raise ValueError(f"{name}: 1 to {MAX_SHARDS} {what}, got "
                         f"{len(shards)}")
    first = shards[0]
    for s in shards:
        if not isinstance(s, torch.Tensor) or s.dim() != dim \
                or s.shape != first.shape or s.dtype != first.dtype \
                or 0 in s.shape:
            raise ValueError(f"{name}: {what} must be non-empty {dim}-D "
                             f"tensors of one shape and type, got "
                             f"{[(tuple(t.shape), t.dtype) for t in shards]}")
    return shards


def _peer_device(name: str, shards, *routing: torch.Tensor) -> torch.device:
    """The calling position's device (the routing's): the CPU, where every
    shard must lie too (the plain version), or a CUDA card, where every
    shard must be a contiguous CUDA tensor, on this card or on a peer card
    that this card is then given peer access to."""
    dev = _device_of(name, *routing)
    places = {s.device for s in shards}
    if dev.type == "cpu":
        if places != {dev}:
            raise ValueError(f"{name}: routing on the CPU but shards on "
                             f"{sorted(map(str, places))}")
        return dev
    if any(p.type != "cuda" for p in places):
        raise ValueError(f"{name}: routing on {dev} but shards on "
                         f"{sorted(map(str, places))}")
    if not all(s.is_contiguous() for s in shards):
        raise ValueError(f"{name} needs contiguous shards")
    for p in places:
        enable_peer_access(dev.index, p.index)
    return dev


def _pointers(shards) -> ctypes.Array:
    return (ctypes.c_void_p * len(shards))(*[s.data_ptr() for s in shards])


def routed_gather(shards, owner: torch.Tensor,
                  local: torch.Tensor) -> torch.Tensor:
    """One clique's owner-routed row gather: ``out[i] =
    shards[owner[i]][local[i]]``, zeros where ``owner[i] < 0`` (host-fill
    misses).

    shards: a sequence of K_g (1 to ``MAX_SHARDS``) tensors (R, Dp) of one
    shape and type, R >= 1, f32 or bf16 (any element type the copy can
    move), each its own allocation, possibly on different cards (each mesh
    position's shard on its card); owner, local: (n,) int32 on the calling
    position's device, where the (n, Dp) output lies.  An owner past
    K_g - 1 and a slot outside [0, R) are clamped (the reference's dense
    oracle clamps them the same way), never rejected.  The sharded executor
    calls this once per mesh position and step; the kernel reads each shard
    through its base pointer, a peer card's over NVLink.
    """
    shards = _shard_list("routed_gather", shards, 2, "shards")
    if owner.dtype != torch.int32 or local.dtype != torch.int32:
        raise TypeError(f"owner and local must be int32, got {owner.dtype} "
                        f"and {local.dtype}")
    if owner.dim() != 1 or local.shape != owner.shape:
        raise ValueError(f"owner and local must be (n,) alike, got "
                         f"{tuple(owner.shape)} and {tuple(local.shape)}")
    dev = _peer_device("routed_gather", shards, owner, local)
    if dev.type == "cpu":
        return ref.routed_gather_peer(shards, owner, local)
    R, D = shards[0].shape
    out = torch.empty((owner.shape[0], D), dtype=shards[0].dtype, device=dev)
    if out.numel() == 0:
        return out  # nothing to launch
    fn = ROUTED_KERNEL.fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_pointers(shards), owner.data_ptr(), local.data_ptr(),
                 out.data_ptr(), owner.shape[0], len(shards), R,
                 D * shards[0].element_size(), stream)
    ROUTED_KERNEL.check(err)
    ROUTED_KERNEL.count_launch()
    return out


def _csr_shards(name: str, indptr_shards, indices_shards) -> tuple:
    indptr_shards = _shard_list(name, indptr_shards, 1, "indptr shards")
    indices_shards = _shard_list(name, indices_shards, 1, "indices shards")
    if len(indptr_shards) != len(indices_shards):
        raise ValueError(f"{name}: {len(indptr_shards)} indptr shards but "
                         f"{len(indices_shards)} indices shards")
    if indptr_shards[0].dtype != torch.int64 \
            or indices_shards[0].dtype != torch.int32:
        raise TypeError(f"indptr shards must be int64 and indices shards "
                        f"int32, got {indptr_shards[0].dtype} and "
                        f"{indices_shards[0].dtype}")
    return indptr_shards, indices_shards


def routed_neighbor_sample(indptr_shards, indices_shards,
                           owner: torch.Tensor, local: torch.Tensor,
                           rand: torch.Tensor) -> torch.Tensor:
    """One clique's owner-routed fixed-fanout sampling:
    ``out[i, j] = indices[owner[i]][start + rand[i, j] % deg]`` with
    ``start``/``deg`` from row ``local[i]`` of the owner's CSR shard, -1
    where ``owner[i] < 0`` (topology miss) or the vertex has degree 0.

    indptr_shards: K_g (1 to ``MAX_SHARDS``) int64 tensors (R+1,), pad rows
    repeating the last offset; indices_shards: K_g int32 tensors (E,) with
    E >= 1; each its own allocation, possibly on different cards.  owner,
    local: (n,) int32 and rand: (n, f) int64 draws (the host sampler's, in
    [0, 2^31)) on the calling position's device, where the (n, f) int32
    output lies.  Owners, slots and offsets out of range clamp as in the
    reference's dense oracle.  The per-hop sampler
    (``device_sample_cached``) calls this once a hop.
    """
    indptr_shards, indices_shards = _csr_shards(
        "routed_neighbor_sample", indptr_shards, indices_shards)
    if owner.dtype != torch.int32 or local.dtype != torch.int32 \
            or rand.dtype != torch.int64:
        raise TypeError(f"owner and local must be int32 and rand int64, got "
                        f"{owner.dtype}, {local.dtype}, {rand.dtype}")
    if owner.dim() != 1 or local.shape != owner.shape or rand.dim() != 2 \
            or rand.shape[0] != owner.shape[0]:
        raise ValueError(f"owner, local (n,) and rand (n, f) must agree, got "
                         f"{tuple(owner.shape)}, {tuple(local.shape)}, "
                         f"{tuple(rand.shape)}")
    dev = _peer_device("routed_neighbor_sample",
                       indptr_shards + indices_shards, owner, local, rand)
    if dev.type == "cpu":
        return ref.routed_neighbor_sample_peer(indptr_shards, indices_shards,
                                               owner, local, rand)
    n, f = rand.shape
    out = torch.empty((n, f), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out  # nothing to launch
    fn = SAMPLE_KERNEL.fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_pointers(indptr_shards), _pointers(indices_shards),
                 owner.data_ptr(), local.data_ptr(), rand.data_ptr(),
                 out.data_ptr(), n, f, len(indptr_shards),
                 indptr_shards[0].shape[0], indices_shards[0].shape[0],
                 stream)
    SAMPLE_KERNEL.check(err)
    SAMPLE_KERNEL.count_launch("hop")
    return out


def _chain_buffer(n_seeds: int, fanouts, device) -> tuple:
    """One chain's packed output: a uint8 buffer holding every hop's
    neighbors ``(n_k, f_k)`` int32 one after the other, then every hop's
    hit flags ``(n_k,)`` one byte each.  Returns its per-hop views
    (neighbors int32, hit masks bool)."""
    rows = [n_seeds]
    for f in fanouts[:-1]:
        rows.append(rows[-1] * f)
    n_out = sum(n * f for n, f in zip(rows, fanouts))
    buf = torch.empty(4 * n_out + sum(rows), dtype=torch.uint8,
                      device=device)
    outs, hits, off = [], [], 0
    for n, f in zip(rows, fanouts):
        outs.append(buf[off:off + 4 * n * f].view(torch.int32).view(n, f))
        off += 4 * n * f
    for n in rows:
        hits.append(buf[off:off + n].view(torch.bool))
        off += n
    return outs, hits


def routed_neighbor_sample_chain(indptr_shards, indices_shards,
                                 topo_owner: torch.Tensor,
                                 topo_local: torch.Tensor,
                                 seeds: torch.Tensor, rands) -> tuple:
    """Every hop of one device-sampling chain of a sharded topology cache,
    routing included, in one launch: per hop ``k``, frontier vertex ``v``
    (the seeds, then hop ``k - 1``'s flattened output) samples ``f_k``
    neighbors from row ``topo_local[v]`` of shard ``topo_owner[v]``'s CSR
    with the draws ``rands[k]``; ``v < 0`` and ``topo_owner[v] < 0`` are
    misses (-1 rows), as is degree 0.

    indptr_shards (K_g of (R+1,) int64) and indices_shards (K_g of (E,)
    int32) as for ``routed_neighbor_sample``, possibly on different cards;
    topo_owner (N,) int32 and topo_local (N,) int64 with N >= 1, seeds
    (n_0,) int64 and rands (1 to ``MAX_CHAIN_HOPS`` int64 draws
    ``(n_k, f_k)`` with ``n_{k+1} = n_k * f_k``) on the sampling position's
    device, where the outputs lie.  Vertices, owners, slots and offsets out
    of range clamp as in ``ref.routed_neighbor_sample_chain_peer``, which
    this equals bit for bit (and which equals the dense
    ``ref.routed_neighbor_sample_chain`` over the stacked shards).  Returns
    (per-hop neighbors (n_k, f_k) int32, per-hop hit masks (n_k,) bool),
    all views of one packed buffer that ``graph.sampling`` reads back with
    one copy.
    """
    rands = list(rands)
    if not 1 <= len(rands) <= MAX_CHAIN_HOPS:
        raise ValueError(f"a chain has 1 to {MAX_CHAIN_HOPS} hops, got "
                         f"{len(rands)}")
    indptr_shards, indices_shards = _csr_shards(
        "routed_neighbor_sample_chain", indptr_shards, indices_shards)
    if topo_owner.dtype != torch.int32 or topo_local.dtype != torch.int64 \
            or seeds.dtype != torch.int64 \
            or any(r.dtype != torch.int64 for r in rands):
        raise TypeError(f"topo_owner must be int32, topo_local, seeds and "
                        f"rands int64, got {topo_owner.dtype}, "
                        f"{topo_local.dtype}, {seeds.dtype}, "
                        f"{[r.dtype for r in rands]}")
    if topo_owner.dim() != 1 or topo_owner.shape[0] < 1 \
            or topo_local.shape != topo_owner.shape or seeds.dim() != 1:
        raise ValueError(f"topo_owner, topo_local (N,) with N >= 1 and seeds "
                         f"(n,) must agree, got {tuple(topo_owner.shape)}, "
                         f"{tuple(topo_local.shape)}, {tuple(seeds.shape)}")
    n = seeds.shape[0]
    for k, r in enumerate(rands):
        if r.dim() != 2 or r.shape[0] != n:
            raise ValueError(f"rands[{k}] must be ({n}, f), got "
                             f"{tuple(r.shape)}")
        n = r.numel()
    fanouts = [r.shape[1] for r in rands]
    # the kernel walks to the last hop, or to the first of fanout 0
    walk = fanouts.index(0) + 1 if 0 in fanouts else len(fanouts)
    rows = seeds.shape[0] * math.prod(fanouts[:walk - 1])
    if rows * max(-(-fanouts[walk - 1] // _CHAIN_CHUNK), 1) >= 1 << 31:
        raise ValueError(f"{rows} rows of the last hop at fanouts {fanouts} "
                         "are too many for one launch of the chain kernel")
    dev = _peer_device("routed_neighbor_sample_chain",
                       indptr_shards + indices_shards, topo_owner,
                       topo_local, seeds, *rands)
    outs, hits = _chain_buffer(seeds.shape[0], fanouts, dev)
    if dev.type == "cpu":
        want_o, want_h = ref.routed_neighbor_sample_chain_peer(
            indptr_shards, indices_shards, topo_owner, topo_local, seeds,
            rands)
        for got, want in zip(outs + hits, want_o + want_h):
            got.copy_(want)
        return outs, hits
    if seeds.shape[0] == 0:
        return outs, hits  # nothing to launch
    fn = SAMPLE_KERNEL.fn("routed_neighbor_sample_chain")
    hops = len(rands)
    rand_ptrs = (ctypes.c_void_p * hops)(*[r.data_ptr() for r in rands])
    fanout_arr = (ctypes.c_int32 * hops)(*fanouts)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_pointers(indptr_shards), _pointers(indices_shards),
                 topo_owner.data_ptr(), topo_local.data_ptr(),
                 seeds.data_ptr(), rand_ptrs, fanout_arr, hops,
                 outs[0].data_ptr(), hits[0].data_ptr(), seeds.shape[0],
                 topo_owner.shape[0], len(indptr_shards),
                 indptr_shards[0].shape[0], indices_shards[0].shape[0],
                 stream)
    SAMPLE_KERNEL.check(err)
    SAMPLE_KERNEL.count_launch("chain")
    return outs, hits
