"""Test configuration: force a virtual 8-device CPU mesh.

Tests never require an accelerator: JAX runs on the CPU with 8 virtual
devices so the multi-device sharding layer (mesh + all_to_all corner turn +
CFAR halo exchange) is exercised as the driver's dryrun does.  XLA_FLAGS is
set before backend init and jax_platforms through the config API, which
holds even where the environment names another platform.  The GPU path is
checked by ``python chip_smoke.py`` on the card.
"""

import os
import sys

# The repo root holds chip_smoke.py and bench.py, whose helpers are tested.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables and tracing caches after each test module.

    A full-suite run accumulates gigabytes of live compiled programs across
    ~30 modules; that heap pressure has produced flaky SIGSEGVs inside
    XLA:CPU's compiler on the suite's largest programs while the identical
    compile succeeds in a fresh process.  Modules don't share compilations
    anyway, so the only cost is recompiling a module's own fixtures."""
    yield
    jax.clear_caches()


def _require_dir(path: str, what: str) -> str:
    if not os.path.isdir(path):
        pytest.skip(f"{what} not present at {path}")
    return path


@pytest.fixture(scope="session")
def reference_data():
    """The reference design's data/ directory (golden chirp and map); the
    test skips when it is absent."""
    from fmcw_tpu.utils import io as rio
    return _require_dir(rio.REFERENCE_DATA, "reference data")


@pytest.fixture(scope="session")
def reference_artifacts():
    """The reference simulation's checked-in ADR_quick logs; the test skips
    when they are absent."""
    from fmcw_tpu.golden import adr_quick
    return _require_dir(adr_quick.ARTIFACT_DIR, "reference sim artifacts")
