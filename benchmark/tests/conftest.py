"""CPU tests of the benchmark harness. Card tests are marked ``cuda`` and
skip without a card (decided inside the test, never at import)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE)), HERE]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")
    import torch

    # one thread a test process: workers of a thread a core each oversubscribe the CPU, and a run's
    # window then holds too few images for its checked ones (the harness's runs are timed)
    torch.set_num_threads(1)
