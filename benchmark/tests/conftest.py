"""The benchmark's own tests (run them with ``python -m pytest
benchmark/tests -q`` from the repository root). Tests marked ``card``
need an NVIDIA card and skip without one; each decides so inside the
test."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips on the CPU)")
