"""Smoke tests for scripts/panacus-visualize.py (reference:
scripts/panacus-visualize.py): it must read our hist/growth TSVs and
produce a plot file."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("matplotlib")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "panacus-visualize.py")

from panacus_jax.cli import run_cli  # noqa: E402


def make_tsv(capsys, tmp_path, args, name):
    rc = run_cli(args)
    out = capsys.readouterr().out
    f = tmp_path / name
    f.write_text(out)
    return str(f)


def visualize(tsv, out, extra=()):
    # hermetic subprocess env: the script is matplotlib-only
    env = dict(os.environ, MPLBACKEND="Agg", JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, SCRIPT, tsv, "-o", out, *extra],
        capture_output=True,
        text=True,
        env=env,
        timeout=180,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.getsize(out) > 0


def test_visualize_hist(capsys, t_groups_gfa, tmp_path):
    tsv = make_tsv(capsys, tmp_path, ["hist", t_groups_gfa], "h.tsv")
    visualize(tsv, str(tmp_path / "h.png"))


def test_visualize_histgrowth_with_fit(capsys, t_groups_gfa, tmp_path):
    tsv = make_tsv(
        capsys,
        tmp_path,
        ["histgrowth", "-S", "-a", "-l", "1,2", "-q", "0,0", t_groups_gfa],
        "hg.tsv",
    )
    visualize(
        tsv, str(tmp_path / "hg.pdf"), extra=["--estimate-growth-params"]
    )
