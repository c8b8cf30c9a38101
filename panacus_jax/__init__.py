"""panacus-jax: a pangenome counting and growth framework on JAX/XLA.

A from-scratch re-design of the capabilities of panacus
(marschall-lab/panacus, reference mounted read-only) for JAX/XLA on the
GPU: host-side columnar GFA ingestion feeding a packed node-x-group
membership bit matrix in device memory, from which coverage histograms,
exact pangenome growth curves, ordered growth, similarity matrices, and
reports are derived as dense array programs.
"""

__version__ = "0.1.0"

_git_hash_cache: list = []


def git_hash():
    """Short git hash of the source tree, or None.

    The reference embeds GIT_HASH at compile time (build.rs:1-10) and uses
    it in TSV `# version` comments (src/io.rs:551) and the report footer
    (src/html_report.rs:306-308). Python has no compile step, so we resolve
    it lazily: a `_build_info.py` written at package-build time wins (for
    installed wheels), else `git rev-parse --short HEAD` on the source
    checkout. Cached after the first call.
    """
    if _git_hash_cache:
        return _git_hash_cache[0]
    h = None
    try:
        from ._build_info import GIT_HASH as h  # type: ignore
    except Exception:
        import os
        import subprocess

        pkg_dir = os.path.dirname(os.path.abspath(__file__))
        try:
            # only trust the hash if the repo actually CONTAINS this
            # package — a wheel installed into a venv inside some other
            # project's checkout would otherwise report that project's
            # hash as our provenance
            top = subprocess.run(
                ["git", "rev-parse", "--show-toplevel"],
                cwd=pkg_dir,
                capture_output=True,
                timeout=5,
            )
            ok = False
            if top.returncode == 0:
                toplevel = os.path.realpath(top.stdout.decode().strip())
                # the repo's package must BE the imported package — "some
                # panacus_jax exists in that repo" would let a wheel
                # installed in a venv nested inside a panacus-jax checkout
                # stamp the checkout's HEAD onto the wheel's outputs
                ok = (
                    os.path.realpath(os.path.join(toplevel, "panacus_jax"))
                    == os.path.realpath(pkg_dir)
                )
            if ok:
                out = subprocess.run(
                    ["git", "rev-parse", "--short", "HEAD"],
                    cwd=pkg_dir,
                    capture_output=True,
                    timeout=5,
                )
                if out.returncode == 0:
                    h = out.stdout.decode().strip() or None
        except Exception:
            h = None
    _git_hash_cache.append(h)
    return h


def version_string():
    """`0.1.0-<shorthash>` when the hash is known, else `0.1.0`."""
    h = git_hash()
    return f"{__version__}-{h}" if h else __version__


from .utils import CountType, Threshold, ThresholdContainer  # noqa: F401,E402
