"""Build provenance in writer comments and the report footer.

Reference behavior: build.rs:1-10 embeds GIT_HASH at compile time;
src/io.rs:546-555 substitutes it into the `# version` TSV comment;
src/html_report.rs:306-308 renders `v{version}-{hash}` in the footer.
"""

import re

import panacus_jax
from panacus_jax.io_utils import write_metadata_comments


def test_version_string_carries_git_hash():
    vs = panacus_jax.version_string()
    assert vs.startswith(panacus_jax.__version__)
    h = panacus_jax.git_hash()
    if h is not None:  # source checkout: hash must be embedded
        assert re.fullmatch(r"[0-9a-f]{6,16}", h)
        assert vs == f"{panacus_jax.__version__}-{h}"


def test_metadata_comment_has_version_line():
    comments = write_metadata_comments()
    lines = comments.splitlines()
    assert len(lines) == 2 and lines[1].startswith("# version ")
    assert panacus_jax.version_string() in lines[1]


def test_report_footer_has_version(tmp_path):
    from panacus_jax.report.html import generate_report

    html = generate_report([], "x.gfa")
    assert f"panacus-jax v{panacus_jax.version_string()}" in html
