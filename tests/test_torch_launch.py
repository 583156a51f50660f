"""The port's training CLI (``repro_torch.launch.train``) on the CPU.

``main`` takes 2 steps of one ``reduced()`` arch of each family with
finite losses and the JAX CLI's printed lines; with ``--ckpt-dir`` it
resumes (also from a checkpoint the JAX CLI wrote) and prints the JAX
CLI's resume line; ``--device cuda`` without a card raises rather than
running on the CPU; and a run loads no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import train as cli

ROOT = Path(__file__).resolve().parent.parent
FAMILIES = ["llama3.2-1b", "phi3.5-moe-42b-a6.6b", "xlstm-125m", "zamba2-2.7b",
            "whisper-small", "pixtral-12b"]
STEP = re.compile(r"^step +(\d+) loss (\S+) gnorm (\S+)$", re.MULTILINE)


def _run(capsys, *argv) -> str:
    assert cli.main(["--device", "cpu", *argv]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("arch", FAMILIES)
def test_two_steps_of_each_family(arch, capsys):
    out = _run(capsys, "--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16")
    head = out.splitlines()[0]
    assert head.startswith(f"arch={arch} layers=") and "family=" in head
    steps = STEP.findall(out)
    assert [int(i) for i, _, _ in steps] == [0, 1]
    assert all(math.isfinite(float(x)) for step in steps for x in step[1:])
    assert out.splitlines()[-1].startswith("2 steps in ")


def test_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--arch", "llama3.2-1b", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    first = _run(capsys, *argv, "--steps", "3")
    assert "resumed" not in first and first.splitlines()[-1].startswith("3 steps in ")
    again = _run(capsys, *argv, "--steps", "4")
    assert "resumed from step 2\n" in again
    assert [int(i) for i, _, _ in STEP.findall(again)] == [3]
    assert again.splitlines()[-1].startswith("2 steps in ")


def test_resumes_from_the_jax_clis_checkpoint(tmp_path, capsys, monkeypatch):
    """The JAX CLI's checkpoint of the same arch and sizes restores into
    the port's state: the two CLIs share the on-disk format and the
    printed lines."""
    from repro.launch import train as jcli

    argv = ["--arch", "gemma-2b", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "1", "--steps", "1"]
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    assert jcli.main() == 0
    jax_out = capsys.readouterr().out
    out = _run(capsys, *argv[:-1], "2")
    assert out.splitlines()[0] == jax_out.splitlines()[0]
    assert "resumed from step 1\n" in out
    assert [int(i) for i, _, _ in STEP.findall(out)] == [1]


def test_cuda_without_a_card_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--arch", "llama3.2-1b", "--steps", "1", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--arch", "llama3.2-1b", "--steps", "1"])  # the default is the card
    assert "step" not in capsys.readouterr().out


RUN_CLI = """
import sys
from repro_torch.launch import train
train.main(["--arch", "whisper-small", "--steps", "1", "--batch", "1", "--seq", "16",
            "--device", "cpu"])
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print("LEAKED", leaked)
"""


def test_the_cli_loads_no_jax_and_no_repro():
    out = subprocess.run([sys.executable, "-c", RUN_CLI], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
