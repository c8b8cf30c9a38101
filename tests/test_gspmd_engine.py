"""The production engine path must produce identical results when its
membership matrix is automatically sharded over all visible devices
(GSPMD partitioning, 8 virtual CPU devices in tests)."""

import jax
import numpy as np

from panacus_jax.abacus import build_membership_host
from panacus_jax.ops.engine import CountingEngine


def test_engine_auto_sharded_matches():
    assert len(jax.devices()) == 8
    rng = np.random.default_rng(21)
    n_items, n_groups = 3000, 37
    occ_items = rng.integers(1, n_items + 1, size=40000)
    occ_groups = rng.integers(0, n_groups, size=40000)

    e = CountingEngine(n_items, n_groups)
    n_words = e.n_words
    M_host = np.zeros((n_words, e.n_items_pad), dtype=np.uint32)
    np.bitwise_or.at(
        M_host,
        (occ_groups >> 5, occ_items),
        np.uint32(1) << (occ_groups & 31).astype(np.uint32),
    )
    M_host[:, 0] = 0
    e.build_from_host_matrix(M_host)
    # M must actually be sharded across devices
    assert len(e.M.sharding.device_set) == 8

    w = np.ones(n_items + 1, dtype=np.int32)
    w[0] = 0
    hist = e.hist(w)
    # host oracle
    cov = np.zeros(n_items + 1, dtype=np.int64)
    key = occ_items.astype(np.int64) * n_groups + occ_groups
    uniq = np.unique(key)
    np.add.at(cov, uniq // n_groups, 1)
    want = np.bincount(cov[1:], minlength=n_groups + 1)
    assert hist.tolist() == want[: n_groups + 1].tolist()

    # ordered growth + similarity also run sharded
    og = e.ordered_growth(w.astype(np.int64), 0.0, 1)
    assert og[-1] == int((cov[1:] > 0).sum())
    inter = e.similarity(w.astype(np.float32))
    assert inter.shape == (n_groups, n_groups)
    assert np.allclose(inter, inter.T)
