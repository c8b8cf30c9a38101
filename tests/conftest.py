import os
import sys

# Tests run on the platform JAX_PLATFORMS names, the CPU when it is unset,
# where a virtual 8-device mesh exercises the sharding paths. The
# @pytest.mark.gpu tests run on a card with `JAX_PLATFORMS=cuda pytest -m gpu`
# (chip_smoke.py does so) and skip elsewhere.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test elsewhere."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform})")
    return dev

REFERENCE = "/root/reference"


def reference_file(rel: str) -> str:
    p = os.path.join(REFERENCE, rel)
    if not os.path.exists(p):
        pytest.skip(f"reference fixture {rel} not available")
    return p


@pytest.fixture
def t_groups_gfa():
    return reference_file("tests/test_files/t_groups.gfa")


@pytest.fixture
def chrm_gfa():
    return reference_file("test/chrM_test.gfa")


@pytest.fixture
def cdbg_gfa():
    return reference_file("test/cdbg.gfa")
