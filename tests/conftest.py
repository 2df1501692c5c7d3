import numpy as np
import pytest

# NOTE: no XLA_FLAGS here — tests must see the real single CPU device.
# Multi-device integration tests spawn subprocesses with their own flags.


@pytest.fixture(scope="session")
def coupled_pair():
    from repro.data.synthetic import coupled_logistic

    x, y = coupled_logistic(800, beta_xy=0.0, beta_yx=0.12, seed=3)
    return np.stack([x, y])


@pytest.fixture(scope="session")
def small_network():
    from repro.data.synthetic import logistic_network

    return logistic_network(10, 300, density=0.2, strength=0.25, seed=4)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips from inside the test without one)"
    )
