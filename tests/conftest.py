"""Make ``src/`` and the tests dir importable regardless of invocation.

The canonical tier-1 command sets ``PYTHONPATH=src`` explicitly; this keeps a
bare ``python -m pytest`` working too, and lets test modules import the
``_hypothesis_compat`` shim without a package layout.
"""

import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
# repo root is needed for the ``benchmarks`` package (artifact schema tests)
for p in (str(_ROOT / "src"), str(_ROOT / "tests"), str(_ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped where there is none")
