"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests see 1 CPU device;
only launch/dryrun.py (its own process) forces 512 placeholder devices."""
import importlib.util
import os
import sys

try:  # pragma: no cover - depends on the environment
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    _spec = importlib.util.spec_from_file_location(
        "_hypothesis_stub",
        os.path.join(os.path.dirname(__file__), "_hypothesis_stub.py"),
    )
    _stub = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_stub)
    sys.modules["hypothesis"], sys.modules["hypothesis.strategies"] = (
        _stub.build_modules()
    )

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: runs a hand-written CUDA kernel; the test skips itself where "
        "no CUDA device is present")


@pytest.fixture(scope="session", autouse=True)
def _x64_off():
    jax.config.update("jax_enable_x64", False)
    yield


@pytest.fixture()
def rng():
    return jax.random.PRNGKey(0)
