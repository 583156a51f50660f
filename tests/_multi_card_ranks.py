"""Phase 14 of ``chip_smoke.py`` (the port across four cards) rehearsed on
4 gloo CPU ranks: the same rank routine, ``chip_smoke.multi_card_rank``,
with ``REHEARSAL``'s small widths and ``reduced()`` configs in place of
the card's.  Each rank fails (exits non-zero) where a part misses its pin;
rank 0 writes the results that the tests read.

    PYTHONPATH=src python tests/_multi_card_ranks.py DIRECTORY
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repository root, beside src/)

# phase 14 at a small width: demo_transformer's four one-layer stages at
# d=32 (4/2 heads, S=64, window 16 on the odd layers), 4 microbatches of 2;
# llama3.2-1b and zamba2-2.7b at reduced(), B=4 x 16
REHEARSAL = chip_smoke.MultiCard(
    device="cpu",
    gpipe=dict(d=32, n_layers=4, seq=64, heads=4, kv_heads=2, mlp_mult=2, window=16,
               softcap=50.0, attn_block=128),
    micro=4, microbatch=2,
    llama=dict(chip_smoke.MULTI_LLAMA, batch=4, seq=16),
    zamba=dict(chip_smoke.MULTI_ZAMBA, batch=4, seq=16),
    reduced=True)
RANKS_TIMEOUT_S = 240


def run_ranks(directory: Path) -> dict:
    """The rehearsal on 4 gloo ranks in a child process, killed after
    ``RANKS_TIMEOUT_S``; rank 0's results."""
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, __file__, str(directory)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=str(directory))
    try:
        out, err = proc.communicate(timeout=RANKS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"the 4 gloo ranks hung past {RANKS_TIMEOUT_S} s: "
                             f"{err[-2000:]}") from None
    assert proc.returncode == 0 and "RANKS_OK" in out, (out[-2000:], err[-3000:])
    return json.loads((directory / "results.json").read_text())


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.spawn(chip_smoke.multi_card_rank, args=(sys.argv[1], REHEARSAL), nprocs=chip_smoke.CARDS)
    print("RANKS_OK")
