"""Pytest settings of the benchmark's own tests (python -m pytest portbench).

`card`: a test that runs on an NVIDIA card. It decides inside the test
whether there is one and skips without it."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: runs on a CUDA device; skips without one")
