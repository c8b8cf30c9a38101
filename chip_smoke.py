#!/usr/bin/env python
"""Smoke test: the histgrowth main path on one GPU at chromosome scale.

    python chip_smoke.py               # one card (the first visible one)
    python chip_smoke.py --four-cards  # phases 3-4 with M item-sharded over 4

Phases:
 1. environment: the card's name and power limit (nvidia-smi), JAX's
    platform, device kind and count, and the native C scanner. No GPU, a
    wrong card count or no native scanner is a failure;
 2. data: the seeded chr22-scale graph from `bench.make_graph` (900k nodes,
    ~3.6M edges, 90 haplotypes, 337 MB of GFA) under `.bench_data/`;
 3. `histgrowth -c all -a -H -l 0,1,2 -q 0,0.5,1` through the CLI entry
    point: M of every abacus resident on the GPU (or item-sharded over 4
    cards), node/bp/edge hists equal to a numpy oracle built from the
    generator's visit lists, and the whole TSV equal to the one hist.py
    writes from the oracle hists;
 4. `ordered-histgrowth -c bp -H` and `similarity -H`: ordered growth and
    the similarity intersections (P diag(w) P^T) equal to numpy oracles,
    exactly — both device programs are integer programs;
 5. the `gpu`-marked tests, in this process (one JAX process per card);
 6. the wall time of every phase and the stage split `runtime.phase_timer`
    logs for each run, beside the card's name and power limit.

The last line of stdout is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}, printed
only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HISTGROWTH_ARGS = ["-c", "all", "-a", "-H", "-l", "0,1,2", "-q", "0,0.5,1"]


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def check_platform(devices, n_cards: int) -> None:
    platform = devices[0].platform
    check(platform == "gpu", f"JAX platform is gpu (got {platform})")
    check(len(devices) == n_cards, f"{n_cards} device(s) visible (got {len(devices)})")


# -- oracles -----------------------------------------------------------------


class Oracle:
    """Independent numpy recomputation from the generator's visit lists:
    P[p, v] says whether path p visits node v (1-based; column 0 is the
    sentinel), and with -H every path is its own haplotype group."""

    def __init__(self, n_nodes: int, n_paths: int, seed: int):
        import numpy as np

        import bench

        self.n_nodes, self.n_paths = n_nodes, n_paths
        lens, gap_pool = bench.graph_draws(n_nodes, n_paths, seed)
        self.lens = np.zeros(n_nodes + 1, dtype=np.int64)
        self.lens[1:] = lens
        self.visits = [
            bench.path_visits(gap_pool, p, n_nodes) for p in range(n_paths)
        ]
        self.P = np.zeros((n_paths, n_nodes + 1), dtype=bool)
        for p, v in enumerate(self.visits):
            self.P[p, v] = True
        self.max_gap = bench.MAX_GAP

    @staticmethod
    def path_of(label: str) -> int:
        """Path index of a -H group label `s<sample>#<hap>`."""
        sample, hap = label[1:].split("#")
        return 2 * int(sample) + int(hap)

    def hists(self):
        """{'node','bp','edge'} -> int64 coverage histogram [n_paths + 1]."""
        import numpy as np

        G, n = self.n_paths, self.n_nodes
        cov = self.P[:, 1:].sum(axis=0)
        node = np.bincount(cov, minlength=G + 1)
        bp = np.zeros(G + 1, dtype=np.int64)
        np.add.at(bp, cov, self.lens[1:])
        # edge (u, u+g) -> key (g-1)*(n+1) + u; a path visits strictly
        # increasing nodes, so no edge repeats within a path
        keys = np.concatenate(
            [(np.diff(v) - 1) * (n + 1) + v[:-1] for v in self.visits]
        )
        ecov = np.bincount(keys, minlength=self.max_gap * (n + 1))
        ecov = ecov.reshape(self.max_gap, n + 1)
        declared = np.concatenate(
            [ecov[g - 1, 1 : n + 1 - g] for g in range(1, self.max_gap + 1)]
        )
        assert ecov.sum() == declared.sum()  # every traversed edge declared
        edge = np.bincount(declared, minlength=G + 1)
        return {"node": node, "bp": bp, "edge": edge}

    def weights(self, count: str):
        import numpy as np

        w = self.lens.copy() if count == "bp" else np.ones_like(self.lens)
        w[0] = 0
        return w

    def ordered(self, order, w, quorum: float, c_min: int, block=1 << 16):
        """Ordered growth (abacus.rs:988-1032) over the paths in `order`,
        evaluated in item blocks: an item counts at position j iff its
        coverage so far >= ceil((last present position + 1) * quorum),
        >= 1, and its total coverage >= c_min."""
        import numpy as np

        P = self.P[order]
        G = len(order)
        gidx = np.arange(G).reshape(-1, 1)
        res = np.zeros(G, dtype=np.int64)
        for a in range(0, P.shape[1], block):
            Pb = P[:, a : a + block].astype(np.int64)
            cum = np.cumsum(Pb, axis=0)
            lp = np.maximum.accumulate(np.where(Pb > 0, gidx, -1), axis=0)
            thr = np.ceil((lp + 1) * quorum)
            thr[lp < 0] = np.inf
            ok = (cum >= thr) & (cum >= 1) & (cum[-1] >= c_min)
            res += (ok * w[a : a + block]).sum(axis=1)
        return res

    def intersections(self, order, w, block=1 << 16):
        """P diag(w) P^T over the paths in `order`: float64 block products
        whose integer sums stay below 2^53, so the int64 result is exact."""
        import numpy as np

        assert int(w.sum()) < (1 << 53)
        P = self.P[order]
        out = np.zeros((len(order), len(order)))
        for a in range(0, P.shape[1], block):
            Pb = P[:, a : a + block].astype(np.float64)
            out += (Pb * w[a : a + block]) @ Pb.T
        return out.astype(np.int64)


# -- CLI runs ------------------------------------------------------------------


class _PhaseLog(logging.Handler):
    """Collects the `phase <name> done; time elapsed` lines runtime logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("phase "):
            self.lines.append(msg)


def run_cli(argv):
    """Run the CLI in this process. Returns (stdout text, the GraphBroker
    the run used, wall seconds, the phase_timer lines it logged)."""
    from panacus_jax import cli, pipeline

    brokers = []
    base = pipeline.GraphBroker

    class Recorded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            brokers.append(self)

    phases = _PhaseLog()
    logger = logging.getLogger("panacus")
    logger.addHandler(phases)
    pipeline.GraphBroker = Recorded
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.run_cli(argv)
    finally:
        pipeline.GraphBroker = base
        logger.removeHandler(phases)
    wall = time.perf_counter() - t0
    check(rc == 0, f"`{' '.join(argv[:1])}` exits 0")
    return buf.getvalue(), brokers[-1], wall, phases.lines


def check_resident(engine, platform: str, n_devices: int, what: str) -> None:
    from panacus_jax.ops.engine import item_mesh_of

    devs = engine.M.devices()
    if n_devices == 1:
        dev = engine._m_device()
        check(
            dev is not None and dev.platform == platform,
            f"{what}: M {engine.M.shape} resident on {platform} ({dev})",
        )
    else:
        mesh = item_mesh_of(engine.M)
        check(
            mesh is not None
            and mesh.devices.size == n_devices
            and len(devs) == n_devices
            and all(d.platform == platform for d in devs),
            f"{what}: M {engine.M.shape} item-sharded over {len(devs)} "
            f"{platform} devices",
        )


class _Hists:
    def __init__(self, hists):
        self._hists = hists

    def get_hists(self):
        return self._hists


class _GroupAbacus:
    """What the table writers read of an AbacusByGroup, from the oracle."""

    def __init__(self, oracle, count, groups, w):
        self.count, self.groups = count, groups
        self._oracle, self._w = oracle, w
        self._order = [Oracle.path_of(g) for g in groups]

    def calc_growth(self, t_coverage, t_quorum):
        G = len(self.groups)
        c = max(1, t_coverage.to_absolute(G))
        q = max(0.0, t_quorum.to_relative(G))
        res = self._oracle.ordered(self._order, self._w, q, c)
        return [float(x) for x in res]

    def similarity_matrix(self):
        import numpy as np

        inter = self._oracle.intersections(self._order, self._w)
        inter = inter.astype(np.float64)
        return inter, np.diagonal(inter).copy()


class _GroupBroker:
    def __init__(self, ab):
        self._ab = ab

    def get_abacus_by_group(self):
        return self._ab


def phase_histgrowth(gfa, oracle, platform, n_devices, report):
    import numpy as np

    from panacus_jax.analyses.growth import Growth
    from panacus_jax.config import AnalysisParameter
    from panacus_jax.hist import Hist
    from panacus_jax.utils import CountType

    argv = ["histgrowth", *HISTGROWTH_ARGS, gfa]
    out, gb, wall, phases = run_cli(argv)
    report(f"histgrowth -c all run", wall, phases)
    for ct, ab in gb.total_abaci.items():
        check_resident(ab.engine, platform, n_devices, f"{ct} abacus")
    want = oracle.hists()
    cts = [CountType.NODE, CountType.BP, CountType.EDGE]
    for ct in cts:
        got = np.asarray(gb.get_hists()[ct].coverage, dtype=np.int64)
        check(
            np.array_equal(got, want[str(ct)]),
            f"{ct} hist equals the oracle (sum {int(want[str(ct)].sum())})",
        )
    param = AnalysisParameter(
        kind="growth", coverage="0,1,2", quorum="0,0.5,1", add_hist=True
    )
    expected = Growth(param).generate_table(
        _Hists({ct: Hist(ct, [int(x) for x in want[str(ct)]]) for ct in cts})
    )
    check(out == expected + "\n", "histgrowth TSV equals the oracle's")


def phase_groups(gfa, oracle, platform, n_devices, report):
    import numpy as np

    from panacus_jax.analyses.ordered_histgrowth import OrderedHistgrowth
    from panacus_jax.analyses.similarity import Similarity
    from panacus_jax.config import AnalysisParameter
    from panacus_jax.utils import CountType, Threshold

    out, gb, wall, phases = run_cli(["ordered-histgrowth", "-c", "bp", "-H", gfa])
    report("ordered-histgrowth -c bp run", wall, phases)
    ab = gb.get_abacus_by_group()
    check_resident(ab.engine, platform, n_devices, "bp group abacus")
    stub = _GroupAbacus(oracle, CountType.BP, list(ab.groups), oracle.weights("bp"))
    param = AnalysisParameter(
        kind="ordered_growth", count_type=CountType.BP, coverage="1", quorum="0"
    )
    expected = OrderedHistgrowth(param).generate_table(_GroupBroker(stub))
    check(out == expected + "\n", "ordered-histgrowth TSV equals the oracle's")
    t0 = time.perf_counter()
    got = ab.calc_growth(Threshold.absolute(1), Threshold.rel(0.0))
    t_ordered = time.perf_counter() - t0
    want = stub.calc_growth(Threshold.absolute(1), Threshold.rel(0.0))
    check(got == want, f"ordered growth equals the oracle (last {want[-1]:.0f})")
    report(f"ordered growth, warm, {len(ab.groups)} groups", t_ordered, [])

    out, gb, wall, phases = run_cli(["similarity", "-H", gfa])
    report("similarity run", wall, phases)
    ab = gb.get_abacus_by_group()
    check_resident(ab.engine, platform, n_devices, "node group abacus")
    stub = _GroupAbacus(
        oracle, CountType.NODE, list(ab.groups), oracle.weights("node")
    )
    param = AnalysisParameter(kind="similarity", count_type=CountType.NODE)
    expected = Similarity(param).generate_table(_GroupBroker(stub))
    check(out == expected + "\n", "similarity TSV equals the oracle's")
    t0 = time.perf_counter()
    inter, _ = ab.similarity_matrix()
    t_sim = time.perf_counter() - t0
    want, _ = stub.similarity_matrix()
    check(
        np.array_equal(inter.astype(np.int64), want.astype(np.int64)),
        f"similarity intersections equal P diag(w) P^T (trace {int(want.trace())})",
    )
    report(f"similarity, warm, {len(ab.groups)} groups", t_sim, [])


class _Outcomes:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1
        elif report.when == "call":
            self.passed += 1


def phase_gpu_tests():
    import pytest

    outcomes = _Outcomes()
    rc = pytest.main(
        [os.path.join(ROOT, "tests"), "-q", "-m", "gpu", "-p", "no:cacheprovider"],
        plugins=[outcomes],
    )
    check(
        rc == 0 and outcomes.failed == 0 and outcomes.skipped == 0
        and outcomes.passed > 0,
        f"gpu-marked tests: {outcomes.passed} passed, {outcomes.failed} "
        f"failed, {outcomes.skipped} skipped",
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--four-cards",
        action="store_true",
        help="run phases 3-4 with M item-sharded over four cards",
    )
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    # one process per card, and only the cards this run uses: limit the
    # visible set before JAX starts
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = visible.split(",") if visible else [str(i) for i in range(n_cards)]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:n_cards])

    times = []

    def report(name, seconds, phase_lines):
        times.append((name, seconds))
        print(f"  time: {name}: {seconds:.3f} s", flush=True)
        for ln in phase_lines:
            print(f"    {ln}", flush=True)

    try:
        t0 = time.perf_counter()
        print("phase 1: environment", flush=True)
        sys.path.insert(0, ROOT)
        import bench

        try:
            card = bench.card_info()
        except (OSError, subprocess.SubprocessError) as e:
            raise SmokeFailure(f"nvidia-smi found no card: {e}")
        print(f"card: {card}", flush=True)
        import jax

        devs = jax.devices()
        print(
            f"jax {jax.__version__}: platform {devs[0].platform}, "
            f"device_kind {devs[0].device_kind}, count {len(devs)}",
            flush=True,
        )
        check_platform(devs, n_cards)
        from panacus_jax.native import get_lib

        check(get_lib() is not None, "native C scanner loaded")
        report("environment", time.perf_counter() - t0, [])

        t0 = time.perf_counter()
        print("phase 2: data", flush=True)
        gfa = bench.GRAPH
        if not os.path.exists(gfa):
            bench.make_graph(gfa)
        oracle = Oracle(bench.N_NODES, bench.N_PATHS, bench.SEED)
        print(
            f"  graph {gfa}: {os.path.getsize(gfa) / 1e6:.1f} MB, "
            f"{oracle.n_nodes} nodes, {oracle.n_paths} paths",
            flush=True,
        )
        report("data", time.perf_counter() - t0, [])

        t0 = time.perf_counter()
        print("phase 3: histgrowth", flush=True)
        phase_histgrowth(gfa, oracle, "gpu", n_cards, report)
        report("phase 3 total", time.perf_counter() - t0, [])

        t0 = time.perf_counter()
        print("phase 4: ordered growth and similarity", flush=True)
        phase_groups(gfa, oracle, "gpu", n_cards, report)
        report("phase 4 total", time.perf_counter() - t0, [])

        if not args.four_cards:
            t0 = time.perf_counter()
            print("phase 5: gpu-marked tests", flush=True)
            phase_gpu_tests()
            report("gpu-marked tests", time.perf_counter() - t0, [])
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1

    print("phase 6: timings", flush=True)
    print(f"card: {card}", flush=True)
    for name, seconds in times:
        print(f"  {name}: {seconds:.3f} s", flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": devs[0].platform,
                    "kind": devs[0].device_kind,
                    "count": len(devs),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
