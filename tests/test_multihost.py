"""Multi-host ingest: TWO real jax.distributed processes (local
coordinator, Gloo CPU collectives) drive the production broker and the
CLI on a shared GFA fixture. Each process tokenizes only its 32-group
word block (parallel/ingest.multihost_total_abaci); M assembles sharded
over the global 4-device mesh; results must match a single-process run
and the independent numpy oracle.

The reference has no multi-process substrate (rayon threads only,
/root/reference/src/lib.rs:55-67) — this is the SURVEY §5.8 multi-process
scale-out design under test."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

N_NODES = 500
N_SAMPLES = 40  # 40 groups -> 2 group words -> both processes own work


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_fixture(path: str, namer=str):
    """40 single-path samples; node names via `namer` (str -> integer
    names, custom -> string names exercising the mode-3 name hash).
    Returns the per-path visit lists for the oracle."""
    rng = np.random.default_rng(7)
    lens = rng.integers(1, 9, size=N_NODES + 1)
    lens[0] = 0
    lines = ["H\tVN:Z:1.0"]
    for v in range(1, N_NODES + 1):
        lines.append(f"S\t{namer(v)}\t{'A' * int(lens[v])}")
    visits_all = []
    edge_set = set()
    path_lines = []
    for p in range(N_SAMPLES):
        k = int(rng.integers(N_NODES // 4, N_NODES))
        visits = np.sort(
            rng.choice(np.arange(1, N_NODES + 1), size=k, replace=False)
        )
        visits_all.append(visits)
        for a, b in zip(visits[:-1], visits[1:]):
            edge_set.add((int(a), int(b)))
        toks = ",".join(f"{namer(v)}+" for v in visits)
        path_lines.append(f"P\ts{p}#0#chr1\t{toks}\t*")
    for a, b in sorted(edge_set):
        lines.append(f"L\t{namer(a)}\t+\t{namer(b)}\t+\t0M")
    lines.extend(path_lines)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return visits_all, lens, sorted(edge_set)


def _oracle_hists(visits_all, lens):
    mem = np.zeros((N_SAMPLES, N_NODES + 1), dtype=bool)
    for g, visits in enumerate(visits_all):
        mem[g, visits] = True
    cov = mem.sum(axis=0)[1:]
    node_hist = np.bincount(cov, minlength=N_SAMPLES + 1)
    bp_hist = np.bincount(
        cov, weights=lens[1:].astype(np.float64), minlength=N_SAMPLES + 1
    ).astype(np.int64)
    return node_hist, bp_hist


def _dist_env(port: int, pid: int, n_proc: int = 2):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    env["JAX_NUM_PROCESSES"] = str(n_proc)
    env["JAX_PROCESS_ID"] = str(pid)
    return env


def _launch_pair(cmd0, cmd1, port, cwd=REPO, timeout=240, retries=1):
    return _launch_n([cmd0, cmd1], port, cwd, timeout, retries)


def _launch_n(cmds, port, cwd=REPO, timeout=240, retries=1):
    """Run coordinator-linked processes; retry once with a fresh port on
    transient failures (port races / coordinator startup)."""
    procs = [
        subprocess.Popen(
            cmd,
            env=_dist_env(port, pid, n_proc=len(cmds)),
            cwd=cwd,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid, cmd in enumerate(cmds)
    ]
    outs = []
    timed_out = False
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        timed_out = True
    failed = timed_out or any(rc != 0 for rc, _, _ in outs)
    if failed and retries > 0:
        return _launch_n(cmds, _free_port(), cwd, timeout, retries - 1)
    if timed_out:
        pytest.skip("distributed runtime timed out on this box")
    for rc, out, err in outs:
        if rc != 0 and (
            "DEADLINE_EXCEEDED" in err or "barrier" in err.lower()
        ):
            pytest.skip(f"distributed runtime unavailable: {err[-400:]}")
        assert rc == 0, f"worker failed:\nstdout:{out}\nstderr:{err[-2000:]}"
    return outs


def test_two_process_broker_matches_oracle(tmp_path):
    gfa = str(tmp_path / "mh.gfa")
    visits_all, lens, _ = _write_fixture(gfa)
    node_hist, bp_hist = _oracle_hists(visits_all, lens)
    port = _free_port()
    out0, out1 = str(tmp_path / "r0.json"), str(tmp_path / "r1.json")
    worker = os.path.join(HERE, "multihost_worker.py")
    _launch_pair(
        [sys.executable, worker, gfa, out0],
        [sys.executable, worker, gfa, out1],
        port,
    )
    r0 = json.load(open(out0))
    r1 = json.load(open(out1))
    assert r0["n_processes"] == 2 and r0["n_devices"] == 4
    assert r0["m_sharded"], "M must shard over the global 4-device mesh"
    assert r0["path_sliced"], "expected the word-block path-sliced build"
    # scaling efficiency: the word-block partition must actually shrink
    # per-host tokenization — each process owns a balanced share of the
    # path payload and together they cover it exactly once
    s0, s1 = r0["mh_stats"], r1["mh_stats"]
    total = s0["total_payload_bytes"]
    assert total == s1["total_payload_bytes"] > 0
    f0 = s0["tokenized_payload_bytes"] / total
    f1 = s1["tokenized_payload_bytes"] / total
    assert abs((f0 + f1) - 1.0) < 1e-9, (f0, f1)
    assert 0.3 < f0 < 0.7 and 0.3 < f1 < 0.7, (f0, f1)
    # both processes hold the SAME fully-merged results
    assert r0["node_hist"] == r1["node_hist"]
    assert r0["bp_hist"] == r1["bp_hist"]
    assert r0["paths_len_total"] == r1["paths_len_total"]
    # and they match the independent oracle
    assert r0["node_hist"] == node_hist.tolist()
    assert r0["bp_hist"] == bp_hist.tolist()
    # paths_len covers every path with the true lengths
    assert len(r0["paths_len_total"]) == N_SAMPLES
    for (name, nlen, blen), visits in zip(
        r0["paths_len_total"],
        sorted(
            (f"s{p}#0#chr1", v) for p, v in enumerate(visits_all)
        ),
    ):
        pass  # names sorted differently; verified count + totals below
    total_nodes = sum(v for _, v, _ in r0["paths_len_total"])
    assert total_nodes == sum(len(v) for v in visits_all)
    total_bp = sum(v for _, _, v in r0["paths_len_total"])
    assert total_bp == sum(int(lens[v].sum()) for v in visits_all)


def test_two_process_group_abacus_path_sliced(tmp_path):
    """Ordered growth + similarity consume only the membership matrix,
    so an AbacusByGroup requirement keeps the path-sliced build (round 5;
    only the multiplicity table export needs item runs): M shards
    globally and the SPMD group programs produce identical,
    oracle-matching results on both processes."""
    gfa = str(tmp_path / "mh_grp.gfa")
    visits_all, lens, _ = _write_fixture(gfa)
    port = _free_port()
    out0, out1 = str(tmp_path / "g0.json"), str(tmp_path / "g1.json")
    worker = os.path.join(HERE, "multihost_worker.py")
    _launch_pair(
        [sys.executable, worker, gfa, out0, "group"],
        [sys.executable, worker, gfa, out1, "group"],
        port,
    )
    r0 = json.load(open(out0))
    r1 = json.load(open(out1))
    assert r0["m_sharded"] and r0 == {**r1, "process": 0}
    assert r0["path_sliced"], "group abacus must not force the fallback"
    node_hist, _ = _oracle_hists(visits_all, lens)
    assert r0["node_hist"] == node_hist.tolist()
    # ordered growth at (c=1, q=0) is the cumulative union over groups in
    # path order; similarity diag holds per-group node counts
    mem = np.zeros((N_SAMPLES, N_NODES + 1), dtype=bool)
    for g, visits in enumerate(visits_all):
        mem[g, visits] = True
    seen = np.zeros(N_NODES + 1, dtype=bool)
    want_ordered = []
    for g in range(N_SAMPLES):
        seen |= mem[g]
        want_ordered.append(float(seen[1:].sum()))
    assert r0["ordered"] == want_ordered
    assert r0["sim_trace"] == float(mem.sum())


def test_three_process_shared_word_assembly(tmp_path):
    """THREE processes over 40 groups: the payload-balanced cuts land
    inside word 0, so its global row is assembled from up to three
    bit-disjoint partial rows (the gather-and-add path with max_k > 1) —
    results must still match the oracle on every process."""
    gfa = str(tmp_path / "mh3.gfa")
    visits_all, lens, _ = _write_fixture(gfa)
    node_hist, bp_hist = _oracle_hists(visits_all, lens)
    port = _free_port()
    outs_paths = [str(tmp_path / f"t{p}.json") for p in range(3)]
    worker = os.path.join(HERE, "multihost_worker.py")
    _launch_n(
        [[sys.executable, worker, gfa, op] for op in outs_paths],
        port,
        timeout=300,
    )
    rs = [json.load(open(op)) for op in outs_paths]
    assert rs[0]["n_processes"] == 3 and rs[0]["n_devices"] == 6
    assert rs[0]["path_sliced"]
    for r in rs:
        assert r["node_hist"] == node_hist.tolist()
        assert r["bp_hist"] == bp_hist.tolist()
    # three-way payload split, covering the payload exactly once
    fr = [
        r["mh_stats"]["tokenized_payload_bytes"]
        / r["mh_stats"]["total_payload_bytes"]
        for r in rs
    ]
    assert abs(sum(fr) - 1.0) < 1e-9, fr
    assert all(0.15 < f < 0.55 for f in fr), fr


def test_two_process_excluded_runs_path_sliced(tmp_path):
    """Whole-path (name-only) exclude BED rows no longer force the
    redundant fallback: the word-block path-sliced build runs, each
    process marks the excluded items it tokenizes, bitmaps allgather-OR,
    and node/bp/edge hists match the independent oracle."""
    gfa = str(tmp_path / "mh_exc.gfa")
    visits_all, lens, edges = _write_fixture(gfa)
    excluded = [0, 13]  # different group words
    bed = tmp_path / "exc.bed"
    bed.write_text("".join(f"s{p}#0#chr1\n" for p in excluded))

    # oracle: excluded groups lose their columns; every item visited by an
    # excluded path counts 0 (whole-column zeroing)
    keep = [p for p in range(N_SAMPLES) if p not in excluded]
    n_groups = len(keep)
    mem = np.zeros((n_groups, N_NODES + 1), dtype=bool)
    for gi, p in enumerate(keep):
        mem[gi, visits_all[p]] = True
    excl_items = np.zeros(N_NODES + 1, dtype=bool)
    for p in excluded:
        excl_items[visits_all[p]] = True
    cov = mem.sum(axis=0)
    cov[excl_items] = 0
    node_hist = np.bincount(cov[1:], minlength=n_groups + 1)
    bp_hist = np.bincount(
        cov[1:], weights=lens[1:].astype(np.float64), minlength=n_groups + 1
    ).astype(np.int64)
    eidx = {e: i for i, e in enumerate(edges)}
    emem = np.zeros((n_groups, len(edges)), dtype=bool)
    for gi, p in enumerate(keep):
        v = visits_all[p]
        for a, b in zip(v[:-1], v[1:]):
            emem[gi, eidx[(int(a), int(b))]] = True
    excl_e = np.zeros(len(edges), dtype=bool)
    for p in excluded:
        v = visits_all[p]
        for a, b in zip(v[:-1], v[1:]):
            excl_e[eidx[(int(a), int(b))]] = True
    ecov = emem.sum(axis=0)
    ecov[excl_e] = 0
    edge_hist = np.bincount(ecov, minlength=n_groups + 1)

    port = _free_port()
    out0, out1 = str(tmp_path / "e0.json"), str(tmp_path / "e1.json")
    worker = os.path.join(HERE, "multihost_worker.py")
    _launch_pair(
        [sys.executable, worker, gfa, out0, "exclude", str(bed)],
        [sys.executable, worker, gfa, out1, "exclude", str(bed)],
        port,
    )
    r0 = json.load(open(out0))
    r1 = json.load(open(out1))
    assert r0["path_sliced"], "exclude-only run should stay path-sliced"
    assert r0["m_sharded"]
    assert r0["node_hist"] == r1["node_hist"] == node_hist.tolist()
    assert r0["bp_hist"] == bp_hist.tolist()
    assert r0["edge_hist"] == edge_hist.tolist()
    # paths_len still covers EVERY path (excluded ones walk the trailing
    # slab) with full lengths, matching the classic itemizer
    assert len(r0["paths_len_total"]) == N_SAMPLES


def test_two_process_string_names_path_sliced(tmp_path):
    """String node names run path-sliced through the mode-3 native name
    hash instead of falling back to redundant itemization."""
    gfa = str(tmp_path / "mh_str.gfa")
    visits_all, lens, _ = _write_fixture(gfa, namer=lambda v: f"seg.{v}x")
    node_hist, bp_hist = _oracle_hists(visits_all, lens)
    port = _free_port()
    out0, out1 = str(tmp_path / "s0.json"), str(tmp_path / "s1.json")
    worker = os.path.join(HERE, "multihost_worker.py")
    _launch_pair(
        [sys.executable, worker, gfa, out0],
        [sys.executable, worker, gfa, out1],
        port,
    )
    r0 = json.load(open(out0))
    r1 = json.load(open(out1))
    assert r0["path_sliced"], "string-named graph should stay path-sliced"
    assert r0["m_sharded"]
    assert r0["node_hist"] == r1["node_hist"] == node_hist.tolist()
    assert r0["bp_hist"] == bp_hist.tolist()


def test_two_process_cli_hist_matches_single(tmp_path):
    """The full CLI path: `panacus-jax hist -S` under two jax.distributed
    processes — process 0 prints the TSV, process 1 stays silent, and the
    table equals the single-process run."""
    gfa = str(tmp_path / "mh_cli.gfa")
    _write_fixture(gfa)
    cmd = [sys.executable, "-m", "panacus_jax", "hist", "-S", "-c", "node", gfa]

    env1 = dict(os.environ)
    env1["JAX_PLATFORMS"] = "cpu"
    env1["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    single = subprocess.run(
        cmd, env=env1, cwd=REPO, capture_output=True, text=True, timeout=240
    )
    assert single.returncode == 0, single.stderr[-2000:]

    port = _free_port()
    outs = _launch_pair(cmd, cmd, port)
    (rc0, out0, _), (rc1, out1, _) = outs

    def tsv_lines(s):
        # keep only TSV content: Gloo emits unprefixed connectivity
        # chatter to stdout under load ("3 is connected to 3 ranks..."),
        # on top of the "[Gloo]" prefixed lines; every real table line
        # contains a tab and comments start with '#'
        return [
            ln
            for ln in s.splitlines()
            if "\t" in ln and not ln.startswith("#")
        ]

    assert tsv_lines(out0) == tsv_lines(single.stdout)
    assert tsv_lines(out1) == []


def _single_process_result(gfa, subset="", exclude="", table=False):
    """Single-process broker run in this test process (the oracle the
    2-process masked builds must match)."""
    from panacus_jax.broker import GraphBroker, GraphState, Req
    from panacus_jax.config import Grouping
    from panacus_jax.utils import CountType

    gb = GraphBroker()
    reqs = {Req.graph(gfa), Req.NODE, Req.BP, Req.HIST, Req.PATH_LENS}
    if table:
        reqs |= {
            Req.abacus_by_group(CountType.NODE),
            Req.group_table(CountType.NODE),
        }
    state = GraphState(
        graph=gfa, name="mh", subset=subset, exclude=exclude,
        grouping=Grouping.sample(),
    )
    gb.change_graph_state(state, reqs, nice=False)
    hists = gb.get_hists()
    res = {
        "node_hist": [int(x) for x in hists[CountType.NODE].coverage],
        "bp_hist": [int(x) for x in hists[CountType.BP].coverage],
        "paths_len_total": sorted(
            [str(k), v[0], v[1]] for k, v in gb.get_path_lens().items()
        ),
    }
    if table:
        res["table"] = gb.get_abacus_by_group().to_tsv(False, gb.graph_aux)
    return res


def test_two_process_subset_bed_path_sliced(tmp_path):
    """An inclusion BED with COORDINATES (partial node coverage -> bp
    corrections) runs path-sliced: each process interval-walks its group
    range, covered-bp intervals and exclude bitmaps merge, and the result
    equals the single-process run bit for bit (round-5 item 4)."""
    gfa = str(tmp_path / "mh_sub.gfa")
    _write_fixture(gfa)
    bed = tmp_path / "sub.bed"
    rows = []
    for p in range(N_SAMPLES):
        if p % 3 == 0:
            rows.append(f"s{p}#0#chr1\t5\t301\n")  # partial interval
        elif p % 3 == 1:
            rows.append(f"s{p}#0#chr1\n")  # whole path
        # p % 3 == 2: not in the subset at all
    bed.write_text("".join(rows))

    want = _single_process_result(gfa, subset=str(bed))

    port = _free_port()
    out0, out1 = str(tmp_path / "sb0.json"), str(tmp_path / "sb1.json")
    worker = os.path.join(HERE, "multihost_worker.py")
    _launch_pair(
        [sys.executable, worker, gfa, out0, "subset", str(bed)],
        [sys.executable, worker, gfa, out1, "subset", str(bed)],
        port,
    )
    r0 = json.load(open(out0))
    r1 = json.load(open(out1))
    assert r0["path_sliced"], "subset run should take the masked path-sliced build"
    assert r0["m_sharded"]
    # payload split: both processes walk a real share, covering it once
    s0, s1 = r0["mh_stats"], r1["mh_stats"]
    f0 = s0["tokenized_payload_bytes"] / s0["total_payload_bytes"]
    f1 = s1["tokenized_payload_bytes"] / s1["total_payload_bytes"]
    assert abs((f0 + f1) - 1.0) < 1e-9 and 0.3 < f0 < 0.7, (f0, f1)
    assert r0["node_hist"] == r1["node_hist"] == want["node_hist"]
    assert r0["bp_hist"] == r1["bp_hist"] == want["bp_hist"]
    assert r0["paths_len_total"] == want["paths_len_total"]


def test_two_process_coordinate_exclude_path_sliced(tmp_path):
    """Coordinate (not whole-path) exclude BED rows run path-sliced with
    the merged exclude annotations matching the single-process walk."""
    gfa = str(tmp_path / "mh_cex.gfa")
    _write_fixture(gfa)
    bed = tmp_path / "cex.bed"
    bed.write_text(
        "".join(
            f"s{p}#0#chr1\t0\t{120 + 17 * p}\n" for p in range(0, N_SAMPLES, 4)
        )
    )
    want = _single_process_result(gfa, exclude=str(bed))

    port = _free_port()
    out0, out1 = str(tmp_path / "cx0.json"), str(tmp_path / "cx1.json")
    worker = os.path.join(HERE, "multihost_worker.py")
    _launch_pair(
        [sys.executable, worker, gfa, out0, "coordexclude", str(bed)],
        [sys.executable, worker, gfa, out1, "coordexclude", str(bed)],
        port,
    )
    r0 = json.load(open(out0))
    r1 = json.load(open(out1))
    assert r0["path_sliced"]
    assert r0["node_hist"] == r1["node_hist"] == want["node_hist"]
    assert r0["bp_hist"] == r1["bp_hist"] == want["bp_hist"]
    assert r0["paths_len_total"] == want["paths_len_total"]


def test_two_process_table_export_path_sliced(tmp_path):
    """AbacusByGroup table export (per-item multiplicities) no longer
    forces the redundant fallback: sparse triplets allgather across the
    disjoint group ranges and the TSV equals the single-process export
    byte for byte (round-5 item 6)."""
    gfa = str(tmp_path / "mh_tab.gfa")
    _write_fixture(gfa)
    want = _single_process_result(gfa, table=True)

    port = _free_port()
    out0, out1 = str(tmp_path / "tb0.json"), str(tmp_path / "tb1.json")
    worker = os.path.join(HERE, "multihost_worker.py")
    _launch_pair(
        [sys.executable, worker, gfa, out0, "table"],
        [sys.executable, worker, gfa, out1, "table"],
        port,
    )
    r0 = json.load(open(out0))
    r1 = json.load(open(out1))
    assert r0["path_sliced"], "table export should stay path-sliced"
    strip = lambda t: "\n".join(
        l for l in t.splitlines() if not l.startswith("#")
    )
    assert strip(r0["table"]) == strip(r1["table"]) == strip(want["table"])


def test_two_process_subset_plus_exclude_randomized(tmp_path):
    """Randomized COMBINED subset + coordinate-exclude masks: partial
    coverage, partial exclusion, and their interaction (uncovered-bp
    arithmetic against excluded intervals, reference util.rs quirks
    included) must merge across processes to the single-process result."""
    rng = np.random.default_rng(99)
    gfa = str(tmp_path / "mh_combo.gfa")
    _write_fixture(gfa)
    sub = tmp_path / "combo_sub.bed"
    exc = tmp_path / "combo_exc.bed"
    sub_rows, exc_rows = [], []
    for p in range(N_SAMPLES):
        r = rng.integers(0, 4)
        if r == 0:
            a = int(rng.integers(0, 200))
            sub_rows.append(f"s{p}#0#chr1\t{a}\t{a + int(rng.integers(3, 400))}\n")
        elif r == 1:
            sub_rows.append(f"s{p}#0#chr1\n")
        if rng.integers(0, 3) == 0:
            a = int(rng.integers(0, 150))
            exc_rows.append(f"s{p}#0#chr1\t{a}\t{a + int(rng.integers(2, 120))}\n")
    sub.write_text("".join(sub_rows))
    exc.write_text("".join(exc_rows))

    want = _single_process_result(gfa, subset=str(sub), exclude=str(exc))

    port = _free_port()
    out0, out1 = str(tmp_path / "cb0.json"), str(tmp_path / "cb1.json")
    worker = os.path.join(HERE, "multihost_worker.py")
    _launch_pair(
        [sys.executable, worker, gfa, out0, "subset", str(sub), str(exc)],
        [sys.executable, worker, gfa, out1, "subset", str(sub), str(exc)],
        port,
    )
    r0 = json.load(open(out0))
    r1 = json.load(open(out1))
    assert r0["path_sliced"]
    assert r0["node_hist"] == r1["node_hist"] == want["node_hist"]
    assert r0["bp_hist"] == r1["bp_hist"] == want["bp_hist"]
    assert r0["paths_len_total"] == want["paths_len_total"]


def test_three_process_subset_path_sliced(tmp_path):
    """THREE processes + a subset BED: masked partial word rows land in
    shared words (max_k > 1 assembly) and the merged mask state still
    matches the single-process run."""
    gfa = str(tmp_path / "mh3_sub.gfa")
    _write_fixture(gfa)
    bed = tmp_path / "sub3.bed"
    bed.write_text(
        "".join(
            f"s{p}#0#chr1\t3\t{150 + 11 * p}\n" if p % 2 else f"s{p}#0#chr1\n"
            for p in range(0, N_SAMPLES, 2)
        )
    )
    want = _single_process_result(gfa, subset=str(bed))
    port = _free_port()
    outs = [str(tmp_path / f"s3_{p}.json") for p in range(3)]
    worker = os.path.join(HERE, "multihost_worker.py")
    _launch_n(
        [[sys.executable, worker, gfa, op, "subset", str(bed)] for op in outs],
        port,
        timeout=300,
    )
    rs = [json.load(open(op)) for op in outs]
    for r in rs:
        assert r["path_sliced"]
        assert r["node_hist"] == want["node_hist"]
        assert r["bp_hist"] == want["bp_hist"]
        assert r["paths_len_total"] == want["paths_len_total"]
