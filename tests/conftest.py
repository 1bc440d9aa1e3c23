import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (decided in a fixture) "
                   "where torch.cuda.is_available() is false")
    config.addinivalue_line(
        "markers", "multigpu: needs two CUDA cards or more; skips (decided "
                   "in a fixture) where torch.cuda.device_count() < 2")
