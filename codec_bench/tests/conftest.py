"""The benchmark's own tests: CPU tests run anywhere; those marked `cuda`
need a card and skip without one (decided inside the test)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")
