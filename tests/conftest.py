import os
import sys

# NOTE: no XLA_FLAGS here on purpose — smoke tests must see 1 device.
# Multi-device tests spawn subprocesses with their own flags.

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# repo root, so tests can import the tools.analyze gate package
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture(scope="session")
def rng_key():
    import jax

    return jax.random.PRNGKey(0)
