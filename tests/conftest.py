"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches see
the real single CPU device; only launch/dryrun.py (a subprocess) forces
512 host devices."""
import dataclasses

import jax
import pytest

from repro.configs import get_config, reduced


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: paper-scale simulations (minutes, not seconds)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); "
        "skips without one")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def tiny(name: str, **over):
    cfg = reduced(get_config(name))
    if over:
        cfg = dataclasses.replace(cfg, **over)
    return cfg
