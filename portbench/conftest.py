"""pytest settings of the benchmark's own tests (``portbench/tests``).

The ``chip`` marker marks a test that needs a CUDA card; it decides so
inside the test and skips on a machine without one.  Run them all with
``python3 -m pytest portbench/tests -q`` from the root of the checkout.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one (run on the card)")
