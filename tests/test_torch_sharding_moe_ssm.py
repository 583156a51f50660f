"""Sharded MoE and hybrid LM steps on 4 gloo ranks of a (2, 2) CPU mesh
against the unsharded ones (``tests/_sharding_ranks.py``): reduced
phi3.5-moe (ep_fsdp: the experts over "model", d over "data") and
zamba2-2.7b (tp: the Mamba2 projections and the SSD scan's heads over
"model"), in f32.

The loss, the gradient norm and every gradient leaf of a train step, the
prefill's logits and three decode steps' logits are held within 1e-5 of
max|ref|, but for zamba2-2.7b's gradient leaves: the unsharded step's own
move by up to 1.68e-5 of max|ref| (dt_bias; conv_w 1.12e-5) when the
residual width is permuted, the same products summed in another order
(``python tests/_sharding_ranks.py --spread zamba2-2.7b``, seeds 0-2), so
they are held at twice that, ``ZAMBA2_LEAF_TOL``.
"""

from __future__ import annotations

import pytest

from _sharding_ranks import rel_errors, run_ranks

CASES = ("phi3.5-moe-42b-a6.6b", "zamba2-2.7b")
TOL = 1e-5  # of max|ref|
ZAMBA2_LEAF_TOL = 3.4e-5  # twice zamba2's own spread (module docstring)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("sharding_moe_ssm"), CASES)


@pytest.mark.parametrize("arch", CASES)
def test_sharded_train_step_matches_unsharded(results, arch):
    ref, got = results[arch]
    assert got["sharded_leaves"] > 0
    errs = rel_errors({k: ref[k] for k in ("loss", "grad_norm")}, got)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])
    errs = rel_errors({"grads": ref["grads"]}, got)
    assert len(errs) > 10
    worst = max(errs, key=errs.get)
    assert errs[worst] <= (ZAMBA2_LEAF_TOL if arch == "zamba2-2.7b" else TOL), (worst,
                                                                                errs[worst])


@pytest.mark.parametrize("arch", CASES)
def test_sharded_prefill_and_decode_match_unsharded(results, arch):
    ref, got = results[arch]
    errs = rel_errors({k: ref[k] for k in ("prefill", "decode")}, got)
    assert len(errs) == 4
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])
