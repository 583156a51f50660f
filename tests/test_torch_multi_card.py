"""The port across several ranks: ``make_gpipe``'s group mode over NCCL and
gloo, and phase 14 of ``chip_smoke.py`` rehearsed on the CPU.

Group mode sends CUDA tensors over NCCL and CPU tensors over gloo (both
halves of a mixed "cpu:gloo,cuda:nccl" backend); every other (backend,
device) pair raises before any send, so nothing is copied to the host
behind the caller's back.  One collective over the whole group runs before
the first send: NCCL's first point-to-point batch on a group must involve
every rank, and at tick 0 only the first stage sends.

Phase 14 (four cards, one process a card: the GPipe one stage a rank,
llama3.2-1b's train step on the (4, 1) and (2, 2) meshes, zamba2-2.7b's
prefill and decode on (2, 2)) runs its own rank routine on 4 gloo CPU ranks
at a small width and ``reduced()`` configs (``tests/_multi_card_ranks.py``),
held to the card's pins: TOL_GPIPE / TOL_GPIPE_INT8 against rank 0's
in-turn run and codec chain, TOL_SHARD of max|ref| against rank 0's plain
steps.
"""

from __future__ import annotations

import pytest
import torch

from _multi_card_ranks import REHEARSAL, run_ranks
from chip_smoke import CARDS, TOL_GPIPE, TOL_GPIPE_INT8, TOL_SHARD
from repro_torch.runtime import pipeline
from repro_torch.runtime.pipeline import make_gpipe

D, MB = 8, 2
TAKEN = [("nccl", "cuda"), ("gloo", "cpu"), ("cpu:gloo,cuda:nccl", "cpu"),
         ("cpu:gloo,cuda:nccl", "cuda")]
REFUSED = [("nccl", "cpu"), ("nccl", "meta"), ("gloo", "cuda"), ("gloo", "meta"),
           ("cpu:gloo,cuda:nccl", "meta"), ("cpu:nccl", "cpu"), ("cuda:gloo", "cuda"),
           ("cpu:nccl,cuda:gloo", "cpu"), ("cpu:nccl,cuda:gloo", "cuda"), ("mpi", "cpu"),
           ("ucc", "cuda")]


def _backend(monkeypatch, backend: str) -> None:
    monkeypatch.setattr(pipeline.dist, "get_backend", lambda group=None: backend)


@pytest.mark.parametrize("backend, device", TAKEN)
def test_group_mode_takes_each_backend_on_its_own_device(monkeypatch, backend, device):
    _backend(monkeypatch, backend)
    pipeline._check_backend_device(object(), torch.device(device))  # no tensor allocated


@pytest.mark.parametrize("backend, device", REFUSED)
def test_group_mode_refuses_every_other_pair(monkeypatch, backend, device):
    _backend(monkeypatch, backend)
    with pytest.raises(ValueError, match=f"lies on {device}"):
        pipeline._check_backend_device(object(), torch.device(device))


def _recording(monkeypatch, rank: int, world: int, backend: str = "gloo") -> list:
    """``pipeline.dist`` as a recorder of a ``world``-rank group seen from
    ``rank``: each collective and point-to-point batch appends its name
    (and its tensors' shapes and devices) and moves nothing."""
    calls: list = []
    _backend(monkeypatch, backend)
    monkeypatch.setattr(pipeline.dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(pipeline.dist, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(pipeline.dist, "get_global_rank", lambda group, r: r)
    monkeypatch.setattr(pipeline.dist, "P2POp",
                        lambda op, t, peer, group: (op.__name__, peer, tuple(t.shape)))
    monkeypatch.setattr(pipeline.dist, "all_reduce", lambda t, group=None: calls.append(
        ("all_reduce", tuple(t.shape), t.device.type)))
    monkeypatch.setattr(pipeline.dist, "batch_isend_irecv",
                        lambda ops: calls.append(("batch", ops)) or [])
    monkeypatch.setattr(pipeline.dist, "broadcast", lambda t, src, group=None: calls.append(
        ("broadcast", src)))
    return calls


@pytest.mark.parametrize("rank", [0, 1])
def test_one_group_collective_runs_before_the_first_send(monkeypatch, rank):
    """Rank 0 (the first stage: it only sends) and rank 1 (the last: it only
    receives) of a 2-stage pipeline: the first call on the group is one
    all_reduce of one element on x's device, then the point-to-point
    batches, then the final broadcast from the last stage."""
    calls = _recording(monkeypatch, rank, 2)
    pipe = make_gpipe(lambda w, x: torch.tanh(x @ w), 2, n_micro=3, group=object())
    pipe(torch.eye(D)[None], torch.zeros(3, MB, D))
    assert calls[0] == ("all_reduce", (1,), "cpu")
    assert [c[0] for c in calls[1:]] == ["batch"] * 3 + ["broadcast"]
    kind = "isend" if rank == 0 else "irecv"
    assert all(op == (kind, 1 - rank, (MB, D)) for c in calls[1:-1] for op in c[1])
    assert calls[-1] == ("broadcast", 1)


def test_a_refused_pair_raises_before_the_collective(monkeypatch):
    """A CPU x on an NCCL group raises before the group-wide collective and
    before any send: no call reaches the group."""
    calls = _recording(monkeypatch, 0, 2, backend="nccl")
    pipe = make_gpipe(lambda w, x: x @ w, 2, n_micro=2, group=object())
    with pytest.raises(ValueError, match=r"sends \['cuda'\] tensors over the nccl group"):
        pipe(torch.eye(D)[None], torch.zeros(2, MB, D))
    assert calls == []


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("multi_card"))


def test_rehearsed_gpipe_on_four_gloo_ranks_equals_rank_0s_runs(rehearsal):
    """(a): bit-equal to rank 0's in-turn run and codec chain (within the
    card's pins); on CPU tensors no rank launches a kernel."""
    g = rehearsal["gpipe"]
    assert g["raw_err"] <= TOL_GPIPE and g["int8_err"] <= TOL_GPIPE_INT8
    assert g["raw_equal"] and g["int8_equal"]
    assert sorted(g["stage_order"]) == list(range(CARDS)) and g["stage_order"] != [0, 1, 2, 3]
    assert all(g[f"{tag}_launches_r{r}"] == {} for tag in ("raw", "int8") for r in range(CARDS))
    mb = REHEARSAL.microbatch * REHEARSAL.gpipe["seq"] * REHEARSAL.gpipe["d"]
    assert g["hop_bytes"] == {"raw": mb * 4, "int8": mb + mb // 256 * 4}  # codes, f32 scales


@pytest.mark.parametrize("mesh", ["(4, 1)", "(2, 2)"])
def test_rehearsed_llama_step_on_each_mesh_equals_the_plain_step(rehearsal, mesh):
    r = rehearsal["llama"][mesh]
    assert max(r["loss_err"], r["grad_norm_err"], r["leaf_err"]) <= TOL_SHARD, r


def test_rehearsed_zamba2_serve_on_the_2x2_mesh_equals_the_plain_run(rehearsal):
    errs = rehearsal["zamba"]["errs"]
    assert sorted(errs) == ["decode/0", "decode/1", "decode/2", "prefill"]
    assert max(errs.values()) <= TOL_SHARD, errs


def test_make_test_mesh_starts_a_one_rank_gloo_group_on_the_cpu():
    """With no group running it starts one rank (gloo on the CPU) and gives
    the (1, 1) mesh; a model axis that does not divide the ranks raises."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    assert not dist.is_initialized()
    try:
        mesh = make_test_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1) and dist.get_backend() == "gloo"
        assert mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(ValueError, match="does not divide"):
            make_test_mesh(device="cpu", model=2)
    finally:
        dist.destroy_process_group()
