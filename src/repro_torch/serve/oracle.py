"""Host-oracle batch for serving parity: assemble the same batch a
``DeviceBatchBuilder.finalize`` produces, but from **host** state only —
cache hits off the clique cache's numpy mirror, misses off the spec's
staged rows — so it can run through the same forward.

Because the device feature table is a bitwise copy of the host mirror, and
padding, positioning and masking are exact-in-float operations (gather,
reshape, multiply by 0.0/1.0), the host-assembled batch equals the fused
device batch **bitwise** at the spec's pinned epoch, and the same forward
then yields bitwise-identical logits.  The oracle must run while the spec's
epoch is still current and before ``finalize`` releases the staging buffer.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.unified_cache import CliqueCache
from repro_torch.train.batch import BatchSpec


def host_oracle_batch(spec: BatchSpec, cache: CliqueCache,
                      feat_dim: int) -> Dict[str, np.ndarray]:
    """Numpy batch (feats_l / mask_l / labels) for a filled device spec,
    gathered from host mirrors — the independent second path the serving
    gather is compared against."""
    n = spec.n_ids
    rows = np.zeros((len(spec.ids), feat_dim), dtype=np.float32)
    hit = spec.hit[:n]
    if hit.any():
        if cache.feat_cache is None:
            raise ValueError("host oracle needs a materialized cache "
                             "mirror (CliqueCache(materialize=True))")
        rows[:n][hit] = cache.feat_cache[spec.cache_pos[:n][hit], :feat_dim]
    inv = spec.miss_inv[:n]
    miss = inv >= 0
    if miss.any():
        rows[:n][miss] = spec.miss_feats.numpy()[inv[miss], :feat_dim]
    batch: Dict[str, np.ndarray] = {"labels": spec.labels}
    for li, (lvl, pos) in enumerate(zip(spec.levels, spec.level_pos)):
        f = rows[pos.reshape(-1)].reshape(lvl.shape + (feat_dim,))
        valid = lvl >= 0
        batch[f"feats_{li}"] = f * valid[..., None].astype(np.float32)
        if li > 0:
            batch[f"mask_{li}"] = valid
    return batch
