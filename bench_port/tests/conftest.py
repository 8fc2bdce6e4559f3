"""The benchmark's own tests: `python -m pytest bench_port/tests -q` from the
repo's root on the CPU; the tests marked `cuda` run on a card and skip
without one."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skipped without one)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
