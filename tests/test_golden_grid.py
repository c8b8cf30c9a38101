"""Golden-grid regression snapshots.

Every case regenerates its full TSV (comments stripped) and diffs it
against tests/golden/<name>.tsv. The grid mirrors the reference's
integrated_test.R parameter sweep (see tests/golden_grid.py); regenerate
snapshots with scripts/gen_golden_grid.py after an intentional change.
"""

import io
import os
from contextlib import redirect_stdout

import pytest

from panacus_jax.cli import run_cli

from golden_grid import CASES, CHRM, GOLDEN_DIR


@pytest.mark.parametrize("name,args", CASES, ids=[c[0] for c in CASES])
def test_golden_grid(name, args, capsys):
    if not os.path.exists(CHRM):
        pytest.skip("reference chrM fixture not available")
    golden_path = os.path.join(GOLDEN_DIR, f"{name}.tsv")
    if not os.path.exists(golden_path):
        pytest.fail(
            f"missing snapshot {golden_path}; "
            "run scripts/gen_golden_grid.py"
        )
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run_cli(list(args))
    capsys.readouterr()
    assert rc == 0
    got = "\n".join(
        l for l in buf.getvalue().splitlines() if not l.startswith("#")
    ).rstrip("\n")
    with open(golden_path) as f:
        want = f.read().rstrip("\n")
    assert got == want, f"output drifted from snapshot for {name}"
