"""Test configuration: force JAX onto CPU with 8 virtual devices so the
multi-device sharding paths are exercised without accelerator hardware
(the standard JAX fake-backend trick)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
# persistent compile cache makes repeat suite runs much faster; an explicit
# JAX_COMPILATION_CACHE_DIR wins (utils/jaxinit.cache_dir)
from nvorbis_tpu.utils.jaxinit import cache_dir  # jax-free import

os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", cache_dir())
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib

import pytest

from nvorbis_tpu.testgen.corpus import FIXTURE_DIR, fixture_path  # noqa: F401

FIXTURES = pathlib.Path(FIXTURE_DIR)


@pytest.fixture(scope="session")
def fixture_dir():
    return FIXTURES
