"""Production mesh definitions, and the card's constants (roofline
denominators).

The JAX package's ``launch/mesh.py`` in PyTorch.  ``make_production_mesh``
is a function (never a module-level constant) so importing this module
touches no process group.  The production meshes keep the JAX package's
shapes, so placements compare case by case: (16, 16) over ("data",
"model"), 256 ranks, and (2, 16, 16) over ("pod", "data", "model"), 512.
They are built on torch's fake process group (``FakeStore``), whose
collectives move nothing: the counterpart of the JAX dry run's
``--xla_force_host_platform_device_count``.  The fake group is the
process's default group, so one process holds one production mesh; the dry
run gives each its own process.

On H100s a 16-wide "model" axis spans two 8-GPU NVLink domains, so half of
its links run over the network at ``NIC_BW`` rather than NVLink: the dry
run's ``t_collective`` (every byte at ``NVLINK_BW``) is a lower bound.
"""

from __future__ import annotations

import torch

# --- NVIDIA H100 SXM 80GB at 700 W (roofline denominators) -----------------
# dense bf16 tensor cores (NVIDIA H100 data sheet, SXM, without sparsity)
PEAK_FLOPS_BF16 = 989e12
# dense TF32 tensor cores and f32 outside them (the same data sheet)
PEAK_FLOPS_TF32 = 495e12
PEAK_FLOPS_F32 = 67e12
# HBM3, bytes/s per GPU (the same data sheet)
HBM_BW = 3.35e12
# NVLink 4: 900 GB/s a GPU to the others of its host, 450 GB/s each way
# (the same data sheet; the JAX package's intra-pod ICI term)
NVLINK_BW = 450e9
# one 400 Gb/s NDR InfiniBand NIC a GPU, 50 GB/s (the JAX package's DCN term)
NIC_BW = 50e9

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False):
    """H100 pod mesh: (16, 16) = 256 GPUs; 2 pods = (2, 16, 16) = 512."""
    return make_fake_mesh(*PRODUCTION_SHAPES[multi_pod])


def make_fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str = "cuda"):
    """A mesh of ``device_type`` devices of ``shape`` over ``axes``, as rank
    0 of a fake process group of that size, which this call starts (a
    process holds one).  No card is needed: its tensors' shards lie on the
    meta device (``launch/dryrun.py``).  (DTensor derives each new op's
    global output shape on fake tensors of the mesh's device type: a torch
    built without CUDA cannot run some of those on CUDA, softmax's backward
    among them, which a CPU mesh can.)"""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        raise RuntimeError("a process group is already running: a process holds one "
                           "fake mesh (the dry run starts one process a mesh)")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(*, device: str = "cuda", init_method: str | None = None, model: int = 1):
    """The running group's ranks on a (n / model, model) ("data", "model")
    mesh of ``device``'s type: (n, 1) by default, as the JAX package's
    mesh of every local device, so (1, 1) on one card and (4, 1) on four
    cards run one process a card.  Starts a one-process group (NCCL on
    CUDA, gloo on the CPU) when none is running; with several local cards
    none is started: each process sets its card
    (``torch.cuda.set_device``) and starts the group first
    (``start_rank_group``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if dev.type == "cuda" and n == 0:
        raise RuntimeError("device='cuda' asked for, but no CUDA device is available")
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"{n} local devices: start one process a device "
                               f"(start_rank_group) and call this in each")
        start_rank_group(0, 1, init_method or _free_tcp(), device=dev.type)
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"a model axis of {model} does not divide the group's {world} ranks")
    return init_device_mesh(dev.type, (world // model, model), mesh_dim_names=("data", "model"))


def start_rank_group(rank: int, world: int, init_method: str, *, device: str = "cuda",
                     timeout_s: float = 600.0) -> None:
    """Start this process's rank of a ``world``-rank group at
    ``init_method``: on CUDA card ``rank`` over NCCL (the card set current
    first, and named as the group's ``device_id``, so NCCL connects at
    once and never guesses a rank's card), on the CPU over gloo."""
    import datetime

    import torch.distributed as dist

    kw = {}
    if device == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=init_method,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)


def _free_tcp() -> str:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"
