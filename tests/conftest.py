"""Test configuration: run JAX on a virtual 8-device CPU mesh by default.

Tests stay hermetic and exercise the multi-device sharding path via
xla_force_host_platform_device_count.  Tests that need the card carry the
``gpu`` marker and skip on the CPU; run them on a GPU machine with
``RUN_ON_GPU=1 python -m pytest -m gpu tests/``.
"""
import os
import sys

if not os.environ.get("RUN_ON_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

_GOLDEN = None


@pytest.fixture(scope="session")
def golden():
    global _GOLDEN
    if _GOLDEN is None:
        path = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")
        _GOLDEN = np.load(path, allow_pickle=False)
    return _GOLDEN


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (RUN_ON_GPU=1 on a GPU machine)")


@pytest.fixture(scope="module", autouse=True)
def _clear_jit_caches_between_modules():
    """Free compiled executables at test-module boundaries.

    The full single-process suite started segfaulting inside the XLA CPU
    compiler (backend_compile_and_load, while compiling an unrelated
    front-end program in test_mu_fused) once the decision-directed
    chanest cond landed — every module passes in isolation and in pairs,
    so the crash needs a long in-process compilation history; clearing
    the jit caches bounds that history.  See CLAUDE.md known issues.
    """
    yield
    import jax
    jax.clear_caches()
