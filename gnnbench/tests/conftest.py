"""Settings of the benchmark's own tests (``python -m pytest
gnnbench/tests``): the ``cuda`` marker for the tests that need a card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
