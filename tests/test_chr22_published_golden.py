"""Large-scale growth parity vs the reference's PUBLISHED chr22 report.

/root/reference/docs/chr22.hprc-v1.0-pggb.histgrowth.html is an actual
panacus output on the 402 MB HPRC chr22 pggb graph (44 haplotype groups).
It embeds, per count type, the coverage histogram and the growth curves
the reference computed for coverage [1,2,1,1,1] x quorum [0,0,1,0.5,0.1].
We parse those at test time (nothing copied into the repo) and check our
math core reproduces every floor()ed growth integer at n=44 — far beyond
the tiny golden vectors in the reference test suite."""

import math
import re

import pytest

from panacus_jax.hist import Hist
from panacus_jax.utils import CountType, ThresholdContainer

from conftest import reference_file


def _parse_report(path: str):
    doc = open(path, errors="replace").read()
    num = r"\[\s*[\d\.,\sEe+-]*?\]"
    hists = {}
    for m in re.finditer(
        rf"new Hist\('(\w+)',\s*({num}),\s*({num})\)", doc
    ):
        name, _labels, values = m.groups()
        hists[name] = [int(x) for x in re.findall(r"-?\d+", values)]
    growths = {}
    for m in re.finditer(
        rf"new Growth\('(\w+)',\s*({num}),\s*({num}),\s*({num}),\s*\[(.*?)\]\]\)",
        doc,
        re.S,
    ):
        name, _labels, cov, quo, curves_blob = m.groups()
        coverage = [float(x) for x in re.findall(r"[\d.]+", cov)]
        quorum = [float(x) for x in re.findall(r"[\d.]+", quo)]
        curves = [
            [int(x) for x in re.findall(r"-?\d+", c)]
            for c in re.findall(rf"{num}", curves_blob + "]")
        ]
        growths[name] = (coverage, quorum, curves)
    return hists, growths


def test_chr22_published_growth_parity():
    path = reference_file("docs/chr22.hprc-v1.0-pggb.histgrowth.html")
    hists, growths = _parse_report(path)
    assert set(hists) == {"bp", "node", "edge"}
    assert set(growths) == {"bp", "node", "edge"}
    for name in ("bp", "node", "edge"):
        hist = hists[name]
        assert len(hist) == 45  # 44 haplotypes + coverage 0
        coverage, quorum, curves = growths[name]
        assert coverage == [1.0, 2.0, 1.0, 1.0, 1.0]
        assert quorum == [0.0, 0.0, 1.0, 0.5, 0.1]
        assert len(curves) == 5 and all(len(c) == 44 for c in curves)

        h = Hist(CountType.parse(name), hist)
        tc = ThresholdContainer.parse_params("0,0,1,0.5,0.1", "1,2,1,1,1")
        ours = h.calc_all_growths(tc)
        for k, want in enumerate(curves):
            got = ours[k][1:]  # strip the NaN 0-slot
            for m, (g, w) in enumerate(zip(got, want), start=1):
                assert math.floor(g) == w, (
                    f"{name} curve {k} (c={coverage[k]}, q={quorum[k]}) "
                    f"m={m}: floor({g}) != published {w}"
                )
