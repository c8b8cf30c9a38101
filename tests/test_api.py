"""Library API surface."""

import numpy as np

import panacus_jax.api as pt


def test_pangenome_api(chrm_gfa):
    pg = pt.Pangenome(chrm_gfa, grouping="sample")
    assert pg.groups == ["chm13", "grch38", "HG00438", "HG00621"]
    assert pg.histogram("node").tolist() == [0, 39, 29, 41, 45]
    assert pg.histogram("bp").tolist() == [0, 616, 31, 601, 15949]
    assert pg.histogram("edge").tolist() == [0, 80, 59, 66, 0]
    g = pg.growth("node", coverage="1", quorum="0")
    assert g.shape == (1, 4)
    assert abs(g[0, -1] - 154.0) < 1e-9
    og, labels = pg.ordered_growth("node")
    assert labels == pg.groups
    assert og[0, -1] == 154.0
    sim, slabels = pg.similarity("node")
    assert sim.shape == (4, 4)
    assert np.allclose(np.diag(sim), 1.0)
    info = pg.info()
    assert info["graph"]["node_count"] == 154
    assert info["graph"]["edge_count"] == 205
