"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a cell can have, and for the control.

Each test drives a whole run of a configured cell at tiny widths on the
CPU (the port's plain path), the look for a card skipped, with one fault
planted in the program: a stage that returns its state unchanged, half of
every microbatch left out (its rows the mean of the rest), an answer
altered where the last stage produces it, and, in the GPipe cell, the
exchange between the ranks left out.  The control puts the reference,
computed with TF32 products, in the program's place.
"""

from __future__ import annotations

import pytest

from seifer_bench import run
from seifer_bench.entries import gpipe
from seifer_bench.tools import calibrate


def _decoded(x):
    return x.decode() if hasattr(x, "decode") and not hasattr(x, "shape") else x


def _state_unchanged(start, stop, x, y):
    return _decoded(x) if start == 0 else y


def _half_batch(start, stop, x, y):
    n = y.shape[0]
    if y.dim() < 3 or n < 2:
        return y
    y = y.clone()
    y[n // 2:] = y[: n // 2].mean(dim=0)
    return y


def _answer_altered(start, stop, x, y):
    y = y.clone()
    y[..., -1, :] = 0.0
    return y


def _planted(fault, last_only):
    import repro_torch.runtime.pipeline as pipeline

    orig = pipeline.make_layer_executor

    def make(layer_fns):
        ex = orig(layer_fns)
        n = len(layer_fns)

        def executor(start, stop, x):
            y = ex(start, stop, x)
            return fault(start, stop, x, y) if (stop == n or not last_only) else y

        executor.fused_codecs = ex.fused_codecs
        return executor

    return make


@pytest.mark.parametrize("workload", ["mamba2-edge-poisson", "attn-edge-closed"])
@pytest.mark.parametrize("fault,last_only", [(_state_unchanged, False), (_half_batch, False),
                                             (_answer_altered, True)])
def test_a_planted_fault_reads_not_correct(tiny_cell, monkeypatch, workload, fault, last_only):
    import repro_torch.runtime.pipeline as pipeline

    monkeypatch.setattr(pipeline, "make_layer_executor", _planted(fault, last_only))
    # offered above capacity, so that the open loop's batches hold several requests
    line, _ = run.measure(tiny_cell(workload, rate=400.0), seed=2**31 + 21, seconds=0.6, trace=False,
                          device="cpu", t_start=0.0)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", ["mamba2-edge-poisson", "attn-edge-closed"])
def test_the_control_reads_not_correct(tiny_cell, workload):
    cell = tiny_cell(workload)
    limits = cell.config["limits"]
    for seed in (2**31 + 31, 2**31 + 32, 2**31 + 33):
        got = calibrate.control(cell, seed, "cpu")
        assert any(got[k] > limits[k] for k in limits), got


def _rank_without_exchange(rank, world, init, ctx, sites, out_q):
    import torch.distributed as dist

    dist.batch_isend_irecv = lambda ops: []  # every boundary stays unsent
    return _original_rank(rank, world, init, ctx, sites, out_q)


_original_rank = gpipe._rank


def test_the_gpipe_without_its_exchange_reads_not_correct(tiny_cell, monkeypatch):
    cell = tiny_cell("attn-gpipe4-closed")
    sound, _ = run.measure(cell, seed=2**31 + 41, seconds=0.3, trace=False, device="cpu",
                           t_start=0.0)
    assert sound["correct"] is True, sound["checks"]
    monkeypatch.setattr(gpipe, "_rank", _rank_without_exchange)
    line, _ = run.measure(cell, seed=2**31 + 41, seconds=0.3, trace=False, device="cpu",
                          t_start=0.0)
    assert line["correct"] is False, line["checks"]


def _rank_that_fails(rank, world, init, ctx, sites, out_q):
    if rank == 1:
        def boom(*args, **kwargs):
            raise RuntimeError("rank 1 fails after joining the group")

        gpipe.weights.draw = boom  # the other ranks go on into a collective
    return _original_rank(rank, world, init, ctx, sites, out_q)


def test_a_failing_rank_ends_every_rank_at_once(tiny_cell, monkeypatch):
    import time

    from seifer_bench.lib.bench import BenchError

    monkeypatch.setattr(gpipe, "_rank", _rank_that_fails)
    t = time.monotonic()
    with pytest.raises(BenchError, match="rank 1 failed"):
        run.measure(tiny_cell("attn-gpipe4-closed"), seed=2**31 + 51, seconds=0.3,
                    trace=False, device="cpu", t_start=0.0)
    assert time.monotonic() - t < gpipe.GROUP_TIMEOUT_S / 2
