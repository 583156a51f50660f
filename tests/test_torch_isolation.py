"""The port stands alone: it imports nothing of JAX and nothing of the JAX
package (``repro``), at run time or in its source."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (imported here, never by the port itself)
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "scripts").glob("*.py")))
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)|from\s+repro\b(?!_torch))",
    re.MULTILINE,
)

SERVE_DEMO_MLP = """
import sys
import torch
from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
from repro_torch.cluster import NodeFailed

d = deploy(DeploymentSpec(model="demo_mlp", codec="int8", device="cpu",
                          cluster=ClusterSpec(n_nodes=6, capacity_bytes=11_000, seed=1)))
for i in range(6):
    d.submit(torch.full((32,), 0.1 * i))
d.inject(NodeFailed(d.control.pipeline.pods[0].node_id))
done = d.drain()
assert len(done) == 6 and all(isinstance(r.result, torch.Tensor) for r in done)
assert "int8" in d.plan.codecs
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print("LEAKED", leaked)
"""


def test_serving_loads_no_jax_and_no_repro():
    out = subprocess.run(
        [sys.executable, "-c", SERVE_DEMO_MLP], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_no_port_source_imports_jax_or_repro():
    assert len(PORT_FILES) > 20 and PORT_FILES[-1].exists()
    offenders = [str(p.relative_to(ROOT)) for p in PORT_FILES
                 if FORBIDDEN.search(p.read_text())]
    assert offenders == []


def test_the_pattern_catches_what_it_should():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("    from repro.core import graph")
    assert FORBIDDEN.search("import repro")
    assert not FORBIDDEN.search("from repro_torch.core import graph")
    assert not FORBIDDEN.search("import repro_torch.api")
