"""pytest settings of the benchmark's tests: the ``card`` marker, for tests
that need a CUDA device and skip, deciding inside the test, where there is
none."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips inside the test without "
        "one")
