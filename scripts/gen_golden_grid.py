#!/usr/bin/env python
"""Regenerate the golden-grid snapshots under tests/golden/.

The grid mirrors the reference's cross-version regression harness
(reference: test/integrated_test.R:76-129): histgrowth over chrM across
grouping x count-type x multi-threshold parameter combinations, plus the
BED subset/exclude masks from test/bed_chrM. Snapshots pin current
behavior so refactors can't silently change any output cell; spot cells
are cross-checked against the reference's golden vectors where those
exist (tests/test_hist.py).

Usage: JAX_PLATFORMS=cpu python scripts/gen_golden_grid.py
"""

import io
import os
import sys
from contextlib import redirect_stdout

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from tests.golden_grid import CASES, GOLDEN_DIR  # noqa: E402

from panacus_jax.cli import run_cli  # noqa: E402


def main() -> None:
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, args in CASES:
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = run_cli(list(args))
        assert rc == 0, (name, rc)
        body = "\n".join(
            l for l in buf.getvalue().splitlines() if not l.startswith("#")
        )
        path = os.path.join(GOLDEN_DIR, f"{name}.tsv")
        with open(path, "w") as f:
            f.write(body + "\n")
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
