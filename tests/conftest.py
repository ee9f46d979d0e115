"""Test-session configuration.

GATE STABILITY (round-4 root cause): a single pytest process accumulating
the full suite's ~340 XLA:CPU jit compilations segfaulted deterministically
inside `backend_compile_and_load` at test 338/339 — cumulative in-process
compiler state (every module passes in isolation; the crash position was
byte-identical across runs). Two independent mitigations keep the
documented gate (`python -m pytest tests/ -q`) green:

  1. `jax.clear_caches()` after every test module (autouse fixture below)
     bounds live compiled-executable state to one module's worth
     (~10-30 programs instead of ~340).
  2. pytest.ini runs the suite under pytest-xdist (`-n 4 --dist loadfile`),
     so no single process ever owns more than ~1/4 of the modules — and
     the wall clock drops ~3x as a side effect.
"""
import os
import sys

import pytest

# Force a virtual 8-device CPU mesh for sharding tests and fp64 numerics.
# Must happen before jax is imported anywhere. With PLL_TEST_GPU=1 (on a
# GPU host, for the `gpu`-marked tests) the accelerator stays visible.
ON_GPU_HOST = os.environ.get("PLL_TEST_GPU") == "1"
if not ON_GPU_HOST:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "true")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
if not ON_GPU_HOST:
    # force CPU through jax.config as well (it wins over a JAX_PLATFORMS
    # set for another backend): deterministic fp64 tests + the 8-device
    # virtual mesh
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when a test asks for it, never
    at import or collection time."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `PLL_TEST_GPU=1 python -m "
                    "pytest tests -m gpu -o addopts=''` on a GPU host")
    return devs[0]


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_compile_state():
    """Drop compiled executables after each module (see module docstring).
    Cross-module cache reuse is near-zero anyway (shapes differ), so this
    costs almost nothing on a warm run."""
    yield
    jax.clear_caches()
