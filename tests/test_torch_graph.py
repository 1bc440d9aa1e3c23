"""Graph layer of the port against the reference package: the same
generator seed gives the same CSR, bitwise-identical virtual features and
labels, and the host sampler draws identical levels."""
import numpy as np
import pytest

from repro.graph import csr as jcsr
from repro.graph import sampling as jsampling
from repro.utils import stable_hash_u32 as j_hash
from repro_torch.graph import csr as tcsr
from repro_torch.graph import sampling as tsampling
from repro_torch.utils import stable_hash_u32 as t_hash

FANOUTS = (5, 3)


@pytest.fixture(scope="module")
def graphs():
    return (jcsr.powerlaw_graph(4000, 10, seed=4, feat_dim=32),
            tcsr.powerlaw_graph(4000, 10, seed=4, feat_dim=32))


def test_csr_identical(graphs):
    gj, gt = graphs
    np.testing.assert_array_equal(gj.indptr, gt.indptr)
    np.testing.assert_array_equal(gj.indices, gt.indices)
    assert (gj.n, gj.feat_dim, gj.n_classes) == (gt.n, gt.feat_dim,
                                                 gt.n_classes)


def test_features_and_labels_bitwise(graphs):
    gj, gt = graphs
    ids = np.random.default_rng(0).integers(0, gj.n, 500)
    fj, ft = gj.get_features(ids), gt.get_features(ids)
    assert ft.dtype == np.float32
    np.testing.assert_array_equal(fj.view(np.uint32), ft.view(np.uint32))
    np.testing.assert_array_equal(gj.get_labels(ids), gt.get_labels(ids))


def test_stable_hash_bitwise():
    x = np.arange(-5, 10_000, 7, dtype=np.int64)
    for salt in (0, 3, 11):
        np.testing.assert_array_equal(j_hash(x, salt), t_hash(x, salt))


def test_synthetic_instance_profile_identical():
    gj = jcsr.synthetic_instance("PR", max_vertices=3000, seed=1)
    gt = tcsr.synthetic_instance("PR", max_vertices=3000, seed=1)
    assert tcsr.PAPER_DATASETS == {k: tcsr.DatasetProfile(**vars(v))
                                   for k, v in jcsr.PAPER_DATASETS.items()}
    np.testing.assert_array_equal(gj.indices, gt.indices)
    ids = np.arange(0, 3000, 13)
    np.testing.assert_array_equal(gj.get_features(ids), gt.get_features(ids))


def test_host_sample_batch_identical(graphs):
    gj, gt = graphs
    seeds = np.random.default_rng(5).integers(0, gj.n, 64)
    seeds[:3] = -1  # padding propagates as -1
    lj = jsampling.host_sample_batch(gj, seeds, FANOUTS,
                                     np.random.default_rng(9))
    lt = tsampling.host_sample_batch(gt, seeds, FANOUTS,
                                     np.random.default_rng(9))
    assert len(lj) == len(lt) == len(FANOUTS) + 1
    for a, b in zip(lj, lt):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jsampling.unique_vertices(lj),
                                  tsampling.unique_vertices(lt))
