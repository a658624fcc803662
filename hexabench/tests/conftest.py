"""The benchmark's own tests: CPU tests at smoke sizes, and tests marked
``card``, which run only where a CUDA device is present and decide so
inside the test."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips (with its reason) "
        "where there is none")
