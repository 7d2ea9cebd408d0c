"""Shared test fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches
must see the real (single) device; multi-device tests spawn subprocesses."""

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def unique_keys(rng, n, lo=1, hi=0xFFFFFF00):
    """Distinct u32 keys avoiding the EMPTY/TOMBSTONE sentinels."""
    ks = rng.choice(np.arange(lo, lo + 4 * n, dtype=np.uint32), size=n,
                    replace=False)
    return ks


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; the test skips without one")
