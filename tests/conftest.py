"""Test environment: force an 8-device virtual CPU mesh before JAX loads.

Multi-device sharding paths are tested on simulated devices
(--xla_force_host_platform_device_count), the same code path that runs on a
multi-GPU mesh; see SURVEY.md section 4 item 3.  Tests stay on the CPU on a
GPU host too: what needs the card is a phase of chip_smoke.py.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Also set through jax.config, which wins over any platform choice made
# before this file ran (e.g. by a site customization).
import jax

jax.config.update("jax_platforms", "cpu")

import pathlib
import sys

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

REFERENCE_DIR = pathlib.Path("/root/reference")

from genome_assembly_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "oracle: needs the reference C source tree to compile an oracle"
    )
    config.addinivalue_line("markers", "slow: long-running test")


@pytest.fixture
def reference_file():
    """``reference_file(name)`` -> path of ``name`` in the reference C
    program's tree; skips the test when the tree is not mounted.  Seeded
    twins of these tests (test_parity_seeded.py) cover the same behaviours
    on generated reads."""

    def get(name: str) -> str:
        path = REFERENCE_DIR / name
        if not path.exists():
            pytest.skip(f"{path} not present")
        return str(path)

    return get


def pytest_collection_modifyitems(config, items):
    if REFERENCE_DIR.exists():
        return
    skip = pytest.mark.skip(reason="/root/reference not mounted")
    for item in items:
        if "oracle" in item.keywords:
            item.add_marker(skip)
