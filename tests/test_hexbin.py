"""Vectorized hexbin vs a scalar reimplementation of the reference's
dual-grid algorithm (reference: src/html_report.rs:789-853)."""

import math

import numpy as np

from panacus_jax.report.hexbin import hexbin, hexbin_arrays


def _dist(x1, y1, x2, y2):
    return math.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)


def scalar_hexbin(points, nx, ny):
    """Direct scalar port of the reference loop — the oracle."""
    if not points:
        return []
    max_coverage = max(p[1] for p in points)
    max_length = max(p[2] for p in points)
    dx = max_coverage / (nx - 1)
    dy = max_length / (ny - 1)
    bins = {}
    for iid, cov, ln in points:
        black_x = math.floor(cov / dx) * dx
        black_y = math.floor(ln / dy) * dy
        green_x = math.floor((cov - dx / 2.0) / dx) * dx + dx / 2.0
        green_y = math.floor((ln - dy / 2.0) / dy) * dy + dy / 2.0
        if black_x < green_x:
            black_x += dx
        else:
            green_x += dx
        if black_y < green_y:
            black_y += dy
        else:
            green_y += dy
        if _dist(cov, ln, black_x, black_y) < _dist(cov, ln, green_x, green_y):
            key = (False, int(black_x / dx), int(black_y / dy))
            b = bins.setdefault(
                key, {"x": black_x, "y": black_y, "size": 0, "content": []}
            )
        else:
            key = (
                True,
                int((green_x - dx / 2.0) / dx),
                int((green_y - dy / 2.0) / dy),
            )
            b = bins.setdefault(
                key, {"x": green_x, "y": green_y, "size": 0, "content": []}
            )
        b["content"].append(iid)
    out = list(bins.values())
    for b in out:
        b["size"] = len(b["content"])
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["size"] == w["size"]
        assert g["content"] == w["content"]
        assert abs(g["x"] - w["x"]) < 1e-12
        assert abs(g["y"] - w["y"]) < 1e-12


def test_hexbin_random_parity():
    rng = np.random.default_rng(11)
    for trial in range(20):
        n = int(rng.integers(1, 400))
        cov = rng.integers(0, 40, size=n)
        lens = rng.integers(1, 10_000, size=n)
        pts = [
            (i + 1, int(c), float(np.log10(l)))
            for i, (c, l) in enumerate(zip(cov, lens))
        ]
        _assert_same(hexbin(pts, 15, 9), scalar_hexbin(pts, 15, 9))


def test_hexbin_grid_edges():
    # points exactly on cell boundaries and the origin
    pts = [(1, 0, 0.0), (2, 10, 1.0), (3, 5, 0.5), (4, 0, 1.0), (5, 10, 0.0)]
    _assert_same(hexbin(pts, 15, 9), scalar_hexbin(pts, 15, 9))


def test_hexbin_arrays_large_fast():
    rng = np.random.default_rng(3)
    n = 200_000
    ids = np.arange(1, n + 1, dtype=np.int64)
    cov = rng.integers(0, 90, size=n).astype(np.float64)
    ln = np.log10(rng.integers(1, 100_000, size=n).astype(np.float64))
    import time

    t0 = time.perf_counter()
    bins = hexbin_arrays(ids, cov, ln, 15, 9)
    assert time.perf_counter() - t0 < 5.0
    assert sum(b["size"] for b in bins) == n
