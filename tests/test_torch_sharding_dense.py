"""Sharded dense LM steps on 4 gloo ranks of a (2, 2) CPU mesh against the
unsharded ones (``tests/_sharding_ranks.py``): reduced llama3.2-1b (tp: q's
heads over "model", its one kv head replicated, the KV caches split over
the sequence) and gemma2-27b (fsdp: d over "data", both kv heads over
"model"), in f32.

The loss, the gradient norm and every gradient leaf of a train step, the
prefill's logits and three decode steps' logits are held within 1e-5 of
max|ref|: the sharded steps sum the same products in another order, and
these steps' own gradient leaves move by up to 2.0e-6 of max|ref| under
such a reordering (the residual width permuted:
``python tests/_sharding_ranks.py --spread ARCH``).
"""

from __future__ import annotations

import pytest

from _sharding_ranks import rel_errors, run_ranks

CASES = ("llama3.2-1b", "gemma2-27b")
TOL = 1e-5  # of max|ref|


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("sharding_dense"), CASES)


@pytest.mark.parametrize("arch", CASES)
def test_sharded_train_step_matches_unsharded(results, arch):
    ref, got = results[arch]
    assert got["sharded_leaves"] > 0
    errs = rel_errors({k: ref[k] for k in ("loss", "grad_norm", "grads")}, got)
    assert len(errs) > 10
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])


@pytest.mark.parametrize("arch", CASES)
def test_sharded_prefill_and_decode_match_unsharded(results, arch):
    ref, got = results[arch]
    errs = rel_errors({k: ref[k] for k in ("prefill", "decode")}, got)
    assert len(errs) == 4
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])


def test_place_gives_every_rank_rank_0s_values(results):
    """Each rank hands ``place`` its own tree; a replicated leaf, like a
    sharded one, then holds rank 0's values on every rank."""
    assert results["place_takes_rank_0s"] == [True] * 4
