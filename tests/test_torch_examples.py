"""The port's examples (``examples/torch_*.py``) run on the CPU.

Each runs as a subprocess with ``--device cpu``.  ``torch_quickstart`` and
``torch_edge_serving_failover`` print the JAX scripts' lines (plans and the
virtual clock, the same numbers); ``torch_pipeline_pods`` prints the JAX
script's plan line, its GPipe within the JAX pipeline test's bounds of the
sequential chain; ``torch_serve_lm`` and ``torch_train_lm`` print the JAX
scripts' formats with finite values, and the loss falls.
"""

from __future__ import annotations

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


# one thread a subprocess: the suite's workers already share the cores
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


def _run(script: str, *argv: str, jax: bool = False) -> str:
    env = {**ENV, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script), *argv],
                         capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=120)
    if not jax:
        assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("name", ["quickstart", "edge_serving_failover"])
def test_prints_the_jax_scripts_lines(name):
    want = _run(f"{name}.py", jax=True)
    got = _run(f"torch_{name}.py", "--device", "cpu") if name != "quickstart" else _run(
        "torch_quickstart.py")
    assert got.splitlines() == want.splitlines() and len(want.splitlines()) >= 8


def test_pipeline_pods():
    # the JAX script prints its plan, then its make_gpipe raises under this
    # JAX (tests/test_pipeline_multidev.py's seed failure)
    plan_line = _run("pipeline_pods.py", jax=True).splitlines()[0]
    out = _run("torch_pipeline_pods.py", "--device", "cpu").splitlines()
    assert plan_line.startswith("SEIFER cuts: (1, 3, 5); stage->pod order: ")
    assert out[0] == plan_line
    exact = re.fullmatch(r"f32 boundaries: max \|err\| vs sequential = (\S+)", out[1])
    lossy = re.fullmatch(r"int8-compressed boundaries: max \|err\| vs sequential = (\S+)",
                         out[2])
    assert float(exact.group(1)) < 1e-6 and 0 < float(lossy.group(1)) < 0.05
    assert out[3] == "pipeline example complete."


def test_serve_lm():
    out = _run("torch_serve_lm.py", "--device", "cpu", "--batch", "2", "--tokens", "6")
    head, timing, sample = out.splitlines()
    assert head == "serving llama3.2-1b (reduced: 4L d=256)"
    rate = re.fullmatch(r"generated 6 tokens x batch 2 in \S+s \((\S+) tok/s on CPU\)", timing)
    assert rate and math.isfinite(float(rate.group(1)))
    tokens = [int(t) for t in re.fullmatch(r"sample: \[(.*)\]", sample).group(1).split(",")]
    assert len(tokens) == 6 and all(0 <= t < 4096 for t in tokens)


def test_train_lm_loss_falls():
    out = _run("torch_train_lm.py", "--device", "cpu", "--steps", "12", "--batch", "4",
               "--seq", "32")
    lines = out.splitlines()
    assert re.fullmatch(r"training llama3.2-1b \(reduced, \S+M params\)", lines[0])
    steps = re.findall(r"^step +(\d+)  loss (\S+)  gnorm (\S+)$", out, re.MULTILINE)
    assert [int(s) for s, _, _ in steps] == [0, 10, 11]
    losses = [float(loss) for _, loss, _ in steps]
    assert all(math.isfinite(float(x)) for step in steps for x in step[1:])
    assert losses[-1] < losses[0]
    assert "checkpoint saved+restored at step 6" in lines
    assert lines[-1].startswith("done in ")


@pytest.mark.parametrize("script", ["torch_edge_serving_failover.py", "torch_serve_lm.py",
                                    "torch_train_lm.py", "torch_pipeline_pods.py"])
def test_cuda_is_the_default_and_raises_without_a_card(script):
    """No ``--device``: the card, and with none a RuntimeError, never the CPU."""
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            f"sys.argv = [{script!r}]\n"
            f"runpy.run_path({str(ROOT / 'examples' / script)!r}, run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=ENV, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr, out.stderr[-2000:]
    assert out.stdout == ""
