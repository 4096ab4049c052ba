import os
import sys

# Tests see the default device count (1 CPU device) -- the 512-device override
# belongs ONLY to repro.launch.dryrun (see its module header).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

try:  # property tests use hypothesis when available ...
    import hypothesis  # noqa: F401
except ImportError:  # ... and a seeded-random shim everywhere else
    from _hypothesis_shim import install

    install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (subprocess with multiple placeholder "
        "devices, or multi-second training loops)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (a hand-written kernel of repro_torch has "
        "no CPU mode); skips where torch.cuda.is_available() is False",
    )
