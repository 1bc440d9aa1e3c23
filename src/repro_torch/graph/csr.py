"""Host-resident CSR graphs + synthetic generators + the paper's datasets.

Graph topology lives in host memory (the paper's CPU side; the GPU's host).
Feature rows come from one of three interchangeable sources, all bitwise
identical for the same graph:

* ``features`` — a materialized in-RAM ``(n, D)`` float32 array (small
  graphs, the classic all-in-host-memory layout);
* ``feature_file`` — an ``.npy`` file read through ``np.memmap`` (the SSD
  tier of the reference package's tiered feature store, which the port
  has not taken over yet);
* *virtual* — neither set: rows are generated deterministically from the
  vertex id (hash-based), so billion-scale profiles never materialize —
  exactly what the cost model and cache planner need.

``save_feature_file`` writes the current rows (whatever their source) to
an ``.npy`` file in bounded-memory chunks, and ``detach_features`` drops
the in-RAM array afterwards, so a graph can be flipped from RAM-resident
to file-backed without ever holding two copies.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.utils import stable_hash_u32


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # int64 (n+1,)
    indices: np.ndarray  # int32 (nnz,)
    n: int
    feat_dim: int
    n_classes: int = 32
    features: Optional[np.ndarray] = None  # (n, D) f32, or None -> virtual
    seed: int = 0
    # SSD-resident feature table: path to an .npy file of shape (n, feat_dim)
    # float32, read via mmap.  Consulted only when ``features`` is None, so
    # a materialized array always wins (same precedence as the docstring).
    feature_file: Optional[str] = None
    # lazy np.memmap handle for feature_file (opened on first read)
    _feat_mmap: Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return (self.indptr[1:] - self.indptr[:-1]).astype(np.int64)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]: self.indptr[v + 1]]

    label_signal: float = 0.5  # feature<->label correlation (learnability)

    def _feature_mmap(self) -> np.ndarray:
        """The memory-mapped feature_file table, opened (and validated
        against this graph's shape/dtype) on first use.  Fancy indexing on
        the returned memmap copies the touched rows out — reads are pure,
        so concurrent readers (the store's async fill worker and the
        prefetch pool) need no lock."""
        if self._feat_mmap is None:
            mm = np.load(self.feature_file, mmap_mode="r")
            if mm.dtype != np.float32 or mm.shape != (self.n, self.feat_dim):
                raise ValueError(
                    f"feature_file {self.feature_file!r} holds "
                    f"{mm.dtype} array of shape {mm.shape}; this graph "
                    f"needs float32 ({self.n}, {self.feat_dim})")
            self._feat_mmap = mm
        return self._feat_mmap

    def get_features(self, ids: np.ndarray) -> np.ndarray:
        """Feature rows for ids; virtual rows are hash-generated on the fly.
        Rows carry a label-dependent offset in the first n_classes dims so
        node classification is learnable (convergence experiments).

        Source precedence: in-RAM ``features`` array, then the mmap'd
        ``feature_file``, then the virtual hash — all three produce
        bitwise-identical rows for a file written by ``save_feature_file``
        (pinned by ``tests/test_feature_store.py``)."""
        if self.features is not None:
            return self.features[ids]
        if self.feature_file is not None:
            ids = np.asarray(ids, dtype=np.int64)
            # fancy indexing on a memmap materializes a fresh in-RAM copy
            # of exactly the requested rows (the mmap "read")
            return np.asarray(self._feature_mmap()[ids], dtype=np.float32)
        ids = np.asarray(ids, dtype=np.int64)
        base = ids[:, None] * np.int64(self.feat_dim) + np.arange(self.feat_dim)
        h = stable_hash_u32(base, salt=self.seed)
        f = (h.astype(np.float32) / 2**32 - 0.5).astype(np.float32)
        if self.label_signal:
            lab = self.get_labels(ids)
            cols = lab % min(self.n_classes, self.feat_dim)
            f[np.arange(len(ids)), cols] += self.label_signal
        return f

    def get_labels(self, ids: np.ndarray) -> np.ndarray:
        h = stable_hash_u32(np.asarray(ids, dtype=np.int64), salt=self.seed + 7)
        return (h % np.uint32(self.n_classes)).astype(np.int32)

    def topology_bytes(self, ids: Optional[np.ndarray] = None,
                       s_uint32: int = 4, s_uint64: int = 8) -> np.ndarray:
        """Per-vertex CSR storage cost (paper Eq. 3): nc(v)*4 + 8."""
        deg = self.degrees() if ids is None else (
            self.indptr[np.asarray(ids) + 1] - self.indptr[np.asarray(ids)])
        return deg * s_uint32 + s_uint64

    def feature_bytes_per_vertex(self, s_float32: int = 4) -> int:
        return self.feat_dim * s_float32

    # ---- file-backed feature source (the tiered store's SSD tier) ----
    def save_feature_file(self, path: str, chunk_rows: int = 65536) -> str:
        """Write this graph's feature rows — from whichever source is
        active — to ``path`` as a standard ``.npy`` file, ``chunk_rows``
        at a time so peak memory stays bounded regardless of ``n``.  The
        written rows are the exact float32 values ``get_features`` returns
        today, so flipping the graph to ``feature_file=path`` afterwards
        is bitwise-invisible to training.  Returns ``path``."""
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        out = np.lib.format.open_memmap(
            path, mode="w+", dtype=np.float32, shape=(self.n, self.feat_dim))
        for a in range(0, self.n, chunk_rows):
            b = min(a + chunk_rows, self.n)
            out[a:b] = self.get_features(np.arange(a, b, dtype=np.int64))
        out.flush()
        del out
        return path

    def detach_features(self, path: Optional[str] = None) -> "CSRGraph":
        """Drop the in-RAM feature array, leaving the graph file-backed
        (``path`` saves first when given) or virtual.  After this,
        ``features`` is None — the layout the tiered feature store's SSD
        tier trains from.  Returns ``self`` for chaining."""
        if path is not None:
            self.save_feature_file(path)
            self.feature_file = path
            self._feat_mmap = None
        if self.features is not None and self.feature_file is None \
                and not self._is_virtual_consistent():
            raise ValueError(
                "detach_features without a feature_file would fall back to "
                "virtual hash rows that differ from the materialized array; "
                "pass path= to save the rows first")
        self.features = None
        return self

    def _is_virtual_consistent(self) -> bool:
        """Whether the materialized array matches the virtual generator
        (true for materialize_features=True synthetic graphs, false for
        externally-loaded feature tables)."""
        if self.features is None or self.n == 0:
            return True
        probe = np.unique(np.linspace(0, self.n - 1, num=min(self.n, 8),
                                      dtype=np.int64))
        saved, self.features = self.features, None
        try:
            virtual = self.get_features(probe)
        finally:
            self.features = saved
        return bool(np.array_equal(self.features[probe], virtual))


def powerlaw_graph(n: int, avg_degree: int, alpha: float = 0.8, seed: int = 0,
                   feat_dim: int = 64, materialize_features: bool = False,
                   n_classes: int = 32) -> CSRGraph:
    """Chung-Lu style power-law graph: endpoint probability ∝ rank^-alpha.

    Degree skew mirrors the web/social graphs in the paper (hot vertices are
    both high-out-degree and frequently sampled).
    """
    rng = np.random.default_rng(seed)
    m = n * avg_degree
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-alpha)
    w /= w.sum()
    # permute so vertex id isn't correlated with hotness
    perm = rng.permutation(n)
    src = perm[rng.choice(n, size=m, p=w)]
    dst = perm[rng.choice(n, size=m, p=w)]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    g = CSRGraph(indptr=indptr, indices=dst.astype(np.int32), n=n,
                 feat_dim=feat_dim, n_classes=n_classes, seed=seed)
    if materialize_features:
        g.features = g.get_features(np.arange(n))
    return g


# ---------------------------------------------------------------------------
# Paper Table 2 dataset profiles.  `sim_scale` maps a profile to a runnable
# synthetic instance; planner/cost-model paths also accept the full-scale
# profile analytically (they only need degrees/hotness/sizes).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    name: str
    n_vertices: int
    n_edges: int
    feat_dim: int
    train_fraction: float = 0.10


PAPER_DATASETS = {
    "PR": DatasetProfile("products", 2_400_000, 120_000_000, 100),
    "PA": DatasetProfile("paper100m", 111_000_000, 1_600_000_000, 128),
    "CO": DatasetProfile("com-friendster", 65_000_000, 1_800_000_000, 256),
    "UKS": DatasetProfile("uk-union", 133_000_000, 5_500_000_000, 256),
    "UKL": DatasetProfile("uk-2014", 790_000_000, 47_200_000_000, 128),
    "CL": DatasetProfile("clue-web", 1_000_000_000, 42_500_000_000, 128),
}


def synthetic_instance(profile_key: str, max_vertices: int = 200_000,
                       seed: int = 0) -> CSRGraph:
    """A runnable scaled-down instance of a paper dataset profile, preserving
    average degree, feature dim, and power-law skew."""
    p = PAPER_DATASETS[profile_key]
    n = min(p.n_vertices, max_vertices)
    avg_deg = max(int(p.n_edges / p.n_vertices), 2)
    return powerlaw_graph(n, min(avg_deg, 64), seed=seed, feat_dim=p.feat_dim)
