"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its numpy
oracles agree with the CLI runs it checks, on a tiny seeded graph (M
item-sharded over the virtual CPU mesh, as with several cards)."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

import jax

import bench
import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_smoke_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_platform_check_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_platform(jax.devices(), 1)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    n_nodes, n_paths, seed = 5000, 10, 3
    gfa = str(tmp_path_factory.mktemp("smoke") / "tiny.gfa")
    bench.make_graph(gfa, n_nodes, n_paths, seed)
    return gfa, chip_smoke.Oracle(n_nodes, n_paths, seed)


def _report(name, seconds, phase_lines):
    assert seconds >= 0


def test_oracle_agrees_with_histgrowth_cli(tiny):
    gfa, oracle = tiny
    hists = oracle.hists()
    assert int(hists["node"].sum()) == oracle.n_nodes
    chip_smoke.phase_histgrowth(
        gfa, oracle, "cpu", len(jax.devices()), _report
    )


def test_oracle_agrees_with_group_cli(tiny):
    gfa, oracle = tiny
    chip_smoke.phase_groups(gfa, oracle, "cpu", len(jax.devices()), _report)


def test_oracle_catches_a_wrong_hist(tiny, monkeypatch):
    """A histogram off by one item fails the smoke's comparison."""
    gfa, oracle = tiny
    real = oracle.hists

    def off_by_one():
        h = real()
        h["edge"][1] += 1
        h["edge"][2] -= 1
        return h

    monkeypatch.setattr(oracle, "hists", off_by_one)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.phase_histgrowth(
            gfa, oracle, "cpu", len(jax.devices()), _report
        )
