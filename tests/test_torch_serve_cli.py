"""The port's serving CLI (``repro_torch.launch.serve``) against the JAX CLI.

With ``--device cpu`` every edge mode prints the JAX CLI's lines, line for
line (the virtual clock, the plans and the reports are the same numbers);
the JAX CLI runs in this process with ``sys.argv`` patched.  ``--arch``
greedy-decodes the JAX CLI's sample from the JAX CLI's own ``PRNGKey(0)``
params, carried across.  ``--device cuda`` without a card raises, and a run
loads neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve as cli

ROOT = Path(__file__).resolve().parent.parent
EDGE_MODES = {
    "demo_mlp": [],
    "replicas": ["--replicas", "3", "--nodes", "12", "--capacity-frac", "0.4",
                 "--requests", "24"],
    "int8": ["--codec", "int8"],
    "auto": ["--codec", "auto", "--tolerance", "0.004"],
    "transformer_int8": ["--model", "demo_transformer", "--codec", "int8"],
    "ssm": ["--model", "demo_ssm"],
    "sync": ["--serving", "sync"],
    "min_sum_greedy": ["--partitioner", "min_sum", "--placer", "greedy"],
    "joint": ["--joint", "joint"],
    "poisson_autoscale": ["--trace", "poisson", "--duration", "0.5", "--autoscale",
                          "--max-batch", "4"],
    # the tenants at the CLI's default 8 nodes: see the test below
    "tenants_12_nodes": ["--tenants", "demo_mlp,demo_ssm", "--nodes", "12",
                         "--requests", "16"],
}


def _jax_cli(monkeypatch, capsys, argv):
    from repro.launch import serve as jcli

    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    assert jcli.main() == 0
    return capsys.readouterr().out


def _port_cli(capsys, argv):
    assert cli.main([*argv, "--device", "cpu"]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("mode", sorted(EDGE_MODES))
def test_edge_mode_prints_the_jax_clis_lines(mode, monkeypatch, capsys):
    argv = ["--edge", *EDGE_MODES[mode]]
    want = _jax_cli(monkeypatch, capsys, argv)
    got = _port_cli(capsys, argv)
    assert got.splitlines() == want.splitlines()
    assert "killing node" in got


def test_tenants_at_8_nodes_fail_as_the_jax_cli_does(monkeypatch, capsys):
    """At the default 8 nodes the kill leaves demo_mlp's 4-node slice too
    small to re-place it: the JAX CLI raises, and so does the port, after
    the same lines."""
    argv = ["--edge", "--tenants", "demo_mlp,demo_ssm", "--requests", "16"]
    from repro.launch import serve as jcli

    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(RuntimeError, match="too degraded"):
        jcli.main()
    want = capsys.readouterr().out
    with pytest.raises(RuntimeError, match="too degraded"):
        cli.main([*argv, "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == want.splitlines()


def test_traced_mode_writes_the_jax_clis_chrome_trace(tmp_path, monkeypatch, capsys):
    argv = ["--edge", "--trace-sample", "1.0", "--trace-out", "trace.json"]
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    want = _jax_cli(monkeypatch, capsys, argv)
    monkeypatch.chdir(tmp_path / "port")
    got = _port_cli(capsys, argv)
    assert got.splitlines() == want.splitlines()
    assert "chrome trace written to trace.json" in got
    traces = [json.loads((tmp_path / side / "trace.json").read_text())
              for side in ("jax", "port")]
    assert traces[0] == traces[1] and traces[0]["traceEvents"]


SAMPLE = re.compile(r"^16 tokens x batch 4 in \S+s \(\S+ tok/s\); sample: (\[.*\])$",
                    re.MULTILINE)


def test_arch_decodes_the_jax_clis_sample(monkeypatch, capsys):
    """llama3.2-1b at ``reduced()``: the JAX CLI's ``PRNGKey(0)`` params
    carried across (``params_from_numpy``) decode the JAX CLI's tokens."""
    import jax
    import numpy as np

    from repro.configs import get_config as jax_config
    from repro.configs import reduced as jax_reduced
    from repro.models import lm as jax_lm
    from repro_torch.models.common import params_from_numpy

    want = _jax_cli(monkeypatch, capsys, ["--arch", "llama3.2-1b"])
    jparams = jax_lm.init_params(jax_reduced(jax_config("llama3.2-1b")), jax.random.PRNGKey(0),
                                 max_pos=128)
    carried = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    drawn = []

    def jax_params(cfg, generator, *, device, max_pos):
        drawn.append((cfg.name, str(device), max_pos))
        return carried

    monkeypatch.setattr(cli.lm, "init_params", jax_params)
    got = _port_cli(capsys, ["--arch", "llama3.2-1b"])
    assert drawn == [("llama3.2-1b", "cpu", 128)]
    assert got.splitlines()[0] == want.splitlines()[0] == "serving llama3.2-1b (reduced=True)"
    assert SAMPLE.findall(got) == SAMPLE.findall(want) != []


def test_arch_with_its_own_params_decodes_in_the_vocabulary(capsys):
    out = _port_cli(capsys, ["--arch", "gemma-2b", "--batch", "2", "--tokens", "4"])
    sample = re.search(r"sample: (\[.*\])$", out, re.MULTILINE)
    tokens = json.loads(sample.group(1))
    assert len(tokens) == 4 and all(0 <= t < cli.get_config("gemma-2b").vocab_size
                                    for t in tokens)
    assert out.splitlines()[0] == "serving gemma-2b (reduced=True)"


@pytest.mark.parametrize("argv", [["--edge", "--requests", "4"],
                                  ["--edge", "--tenants", "demo_mlp,demo_ssm"],
                                  ["--arch", "llama3.2-1b"]])
def test_cuda_without_a_card_raises(argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([*argv, "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)  # the default is the card
    assert capsys.readouterr().out == ""


RUN_CLI = """
import sys
from repro_torch.launch import serve
serve.main(["--edge", "--requests", "8", "--model", "demo_transformer", "--codec", "int8",
            "--device", "cpu"])
serve.main(["--arch", "whisper-small", "--tokens", "2", "--batch", "1", "--device", "cpu"])
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print("LEAKED", leaked)
"""


def test_the_cli_loads_no_jax_and_no_repro():
    out = subprocess.run([sys.executable, "-c", RUN_CLI], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 8/8 requests (lost 0)" in out.stdout
    assert "LEAKED []" in out.stdout, out.stdout
