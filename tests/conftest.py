"""Shared fixtures for the tier-1 suite."""
import pytest


@pytest.fixture(autouse=True)
def _reset_dispatch_count():
    """Zero ops.dispatch_count() around every test.

    The counter is process-global, so without this a test that asserts
    launch counts would see whatever the previously-run module left
    behind — pass/fail would depend on collection order.
    """
    from repro.kernels import ops

    ops.reset_dispatch_count()
    yield
    ops.reset_dispatch_count()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the hand-written kernels have"
        " no CPU mode); skips where there is none")
