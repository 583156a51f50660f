"""The port's launch tooling (``repro_torch.launch``: ``specs``, ``mesh``,
``op_cost``, ``dryrun``, ``report``) and the LM kernels' custom ops
(``kernels/library.py``) against the JAX package's ``launch/`` and the
kernels' own formulas.

- ``specs``' meta trees have ``jax.eval_shape``'s trees, shapes and dtypes
  for every arch and shape cell at full size, with no storage;
- ``op_cost`` counts the dot FLOPs ``repro.launch.hlo_cost.analyze_hlo``
  counts on ``tests/test_hlo_cost.py``'s three programs (their scans as
  Python loops), exactly, and on a reduced llama3.2-1b prefill at S=16
  exactly; on its train step it counts one product more, named and pinned
  (``test_train_step_flops_equal_analyze_hlo_but_the_xent_remat``);
- on a fake 256-rank mesh it counts rank 0's local ops only, and a known
  redistribute's all-gather bytes;
- each custom op's fake outputs have its plain version's shapes and dtypes,
  its registered cost is ``chip_smoke.py``'s bound count, and its sharding
  rule shards what the kernel can take shard by shard;
- ``dryrun``'s CLI runs a full cell on the production mesh (a child
  process: a process holds one fake group), and ``report`` prints the JAX
  ``report``'s tables for the same records.

Each process-group test starts its own group and destroys it after.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs import shape_cells
from repro.launch import report as jax_report
from repro.launch import specs as jax_specs
from repro.launch.hlo_cost import analyze_hlo
from repro.models import lm as jax_lm
from repro.runtime import serve as jax_serve
from repro.runtime import train as jax_train
from repro_torch.configs import ARCHS, SHAPES, get_config, reduced
from repro_torch.kernels import costs
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.library import OP_COSTS
from repro_torch.kernels.ssm_scan import ops as ssd_ops
from repro_torch.launch import report
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.op_cost import OpCostMode

ROOT = Path(__file__).resolve().parent.parent
RECORD_KEYS = {"arch", "shape", "chips", "mesh", "hbm_per_chip_gb", "collective_bytes_per_chip",
               "collective_ops", "collective_bytes_by_op", "t_compute", "t_memory",
               "t_collective", "bottleneck", "model_gflops_total", "useful_flops_ratio",
               "roofline_frac", "gflops_per_chip", "gbytes_per_chip", "trace_s", "ok"}


# --- specs ------------------------------------------------------------------

def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _jax_leaves(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): x
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_trees_equal_eval_shape(arch):
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    for cell in shape_cells(jcfg):
        shape, jshape = SHAPES[cell], JAX_SHAPES[cell]
        pairs = [(specs_lib.input_specs(cfg, shape), jax_specs.input_specs(jcfg, jshape))]
        if shape.kind == "train":
            pairs.append((specs_lib.state_specs(cfg, shape), jax_specs.state_specs(jcfg, jshape)))
        else:
            pairs.append((specs_lib.param_specs(cfg, shape), jax_specs.param_specs(jcfg, jshape)))
        if shape.kind == "decode":
            pairs.append((specs_lib.cache_specs(cfg, shape), jax_specs.cache_specs(jcfg, jshape)))
        for got, want in pairs:
            got, want = dict(_leaves(got)), _jax_leaves(want)
            assert set(got) == set(want), (cell, set(got) ^ set(want))
            for path, x in got.items():
                if isinstance(x, int):  # the caches' position: a Python int here
                    assert path == "pos" and x == 0 and want[path].shape == ()
                    continue
                assert x.device.type == "meta", path  # no storage
                assert tuple(x.shape) == tuple(want[path].shape), (cell, path)
                assert str(x.dtype) == f"torch.{want[path].dtype}", (cell, path)


def test_kimi_k2_specs_build_in_seconds():
    import time

    t0 = time.perf_counter()
    state = specs_lib.state_specs(get_config("kimi-k2-1t-a32b"), SHAPES["train_4k"])
    n = sum(x.numel() for _, x in _leaves(state["params"]))
    assert n > 1e12 and time.perf_counter() - t0 < 10


# --- op_cost against analyze_hlo --------------------------------------------

def _jax_flops(f, *specs) -> float:
    return analyze_hlo(jax.jit(f).lower(*specs).compile().as_text()).flops


def _port_flops(f, *shapes) -> float:
    args = [torch.randn(s) for s in shapes]
    with OpCostMode() as counter:
        f(*args)
    return counter.result().flops


def _scan_free(a, b):
    return (torch.tanh(a @ b) @ b).sum()


def _scan(x, w):
    for _ in range(12):
        x = torch.tanh(x @ w)
    return x.sum()


def _nested(x, w):
    for _ in range(5):
        for _ in range(3):
            x = x @ w
    return x.sum()


def _jax_scan(x, w):
    def step(c, _):
        return jnp.tanh(c @ w), None

    return jax.lax.scan(step, x, None, length=12)[0].sum()


def _jax_nested(x, w):
    def outer(c, _):
        def inner(ci, _):
            return ci @ w, None

        return jax.lax.scan(inner, c, None, length=3)[0], None

    return jax.lax.scan(outer, x, None, length=5)[0].sum()


PROGRAMS = {
    "scan_free": (_scan_free, lambda a, b: (jnp.tanh(a @ b) @ b).sum(), [(256, 256), (256, 256)]),
    "scan_12": (_scan, _jax_scan, [(64, 128), (128, 128)]),
    "nested_3x5": (_nested, _jax_nested, [(32, 64), (64, 64)]),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_op_cost_flops_equal_analyze_hlo(name):
    port, jax_f, shapes = PROGRAMS[name]
    want = _jax_flops(jax_f, *(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes))
    assert want > 0 and _port_flops(port, *shapes) == want


def _reduced_llama_flops(kind: str, b: int, s: int) -> tuple[float, float, object]:
    """(JAX HLO dot FLOPs, the port's on a one-rank fake mesh, cfg) of a
    reduced llama3.2-1b step; the port's in a child process (its group)."""
    jcfg = jax_reduced(jax_get_config("llama3.2-1b"))
    params = jax.eval_shape(lambda: jax_lm.init_params(jcfg, jax.random.PRNGKey(0), max_pos=64))
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    if kind == "train":
        state = jax.eval_shape(lambda p: jax_train.init_state(jcfg, p), params)
        want = _jax_flops(jax_train.make_train_step(jcfg, jax_train.OptConfig()), state, batch)
    else:
        want = _jax_flops(jax_serve.make_prefill_step(jcfg), params, batch)
    out = _child(f"""
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.op_cost import OpCostMode
# a CPU mesh: this torch has no CUDA to derive softmax's backward shapes on
mesh = make_fake_mesh((1, 1), ("data", "model"), device_type="cpu")
cfg = reduced(get_config("llama3.2-1b"))
step, args, cfg, shape = dryrun.build_step(cfg, ShapeConfig("t", {s}, {b}, "{kind}"), mesh)
with OpCostMode() as m:
    step(*args)
print("FLOPS", m.result().flops)
""")
    return want, float(out.split("FLOPS")[-1]), reduced(get_config("llama3.2-1b"))


def test_prefill_flops_equal_analyze_hlo():
    want, got, _ = _reduced_llama_flops("prefill", 2, 16)
    assert got == want


def test_train_step_flops_equal_analyze_hlo_but_the_xent_remat():
    """The one gap: the port rematerializes each cross-entropy chunk
    (``lm.chunked_xent``), so the backward runs its logits product (B, S,
    d) x (d, V) once more, 2 B S d V FLOPs; the JAX package's chunk scan
    keeps the logits for its backward."""
    b, s = 2, 16
    want, got, cfg = _reduced_llama_flops("train", b, s)
    assert got == want + 2 * b * s * cfg.d_model * cfg.vocab_size


# --- on a fake 256-rank mesh ------------------------------------------------

def _child(code: str) -> str:
    """``code`` in a child process (a process holds one process group)."""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_local_ops_and_collective_bytes_on_a_fake_mesh():
    """A (4096, 4096) @ (4096, 4096) product, rows over "data" and columns
    over "model": rank 0 computes its (256, 256) block, 2 * 256 * 4096 * 256
    FLOPs (FlopCounterMode also counts the global product DTensor's shape
    propagation runs); gathering the result whole moves (256, 4096) then
    (4096, 4096) f32 in two all-gathers."""
    out = _child("""
import json
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import OpCostMode
mesh = make_production_mesh()
x = DTensor.from_local(torch.empty(256, 4096, device="meta"), mesh, [Shard(0), Replicate()],
                       run_check=False)
w = DTensor.from_local(torch.empty(4096, 256, device="meta"), mesh, [Replicate(), Shard(1)],
                       run_check=False)
with OpCostMode(track_memory=True, external=(x, w)) as m:
    z = x @ w
    r = z.redistribute(mesh, [Replicate(), Replicate()])
c = m.result()
with FlopCounterMode(display=False) as f:
    x @ w
print("RESULT", json.dumps([c.flops, c.collective_bytes, c.collective_count, c.peak_bytes,
                            f.get_total_flops()]))
""")
    flops, bytes_, count, peak, flop_counter = json.loads(out.split("RESULT")[-1])
    assert flops == 2 * 256 * 4096 * 256
    assert bytes_ == {"all-gather": float((256 * 4096 + 4096 * 4096) * 4)}
    assert count == {"all-gather": 2.0}
    # x, w, the (256, 256) block, the (256, 4096) gather and the whole result
    assert peak >= (2 * 256 * 4096 + 256 * 256 + 256 * 4096 + 4096 * 4096) * 4
    assert flop_counter > flops  # FlopCounterMode counts the global product too


def test_kernel_rules_shard_what_the_kernels_take():
    """Flash shards batch and heads where q and k/v shard their heads alike,
    and asks for replicated heads where the policy replicates k/v (8 KV
    heads on a 16-wide "model" axis); the SSD scan shards batch and heads,
    its B and C replicated, their gradients partial sums over the heads."""
    out = _child("""
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
import repro_torch.sharding  # registers the kernels' rules
from repro_torch.launch.mesh import make_production_mesh
mesh = make_production_mesh()
def d(shape, pl, dtype=torch.float32):
    local = [n // (16 if any(p == Shard(i) for p in pl) else 1) for i, n in enumerate(shape)]
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"), mesh, pl,
                              run_check=False)
heads = [Shard(0), Shard(2)]
q = d((32, 4096, 32, 64), heads)
o16 = torch.ops.repro_torch.flash_attention_fwd(q, d((32, 4096, 16, 64), heads),
                                                d((32, 4096, 16, 64), heads), True, 0, 0.0)
kv8 = d((32, 4096, 8, 64), [Shard(0), Replicate()])
o8, lse8 = torch.ops.repro_torch.flash_attention_fwd_lse(q, kv8, kv8, True, 0, 0.0)
xs = d((32, 4096, 80, 64), heads)
bc = d((32, 4096, 64), [Shard(0), Replicate()])
dt = d((32, 4096, 80), heads)
a = d((80,), [Replicate(), Shard(0)])
y = torch.ops.repro_torch.ssd_chunked_fwd(xs, bc, bc, dt, a, 256)
g = torch.ops.repro_torch.ssd_chunked_bwd(xs, bc, bc, dt, a, d((32, 4096, 80, 64), heads), 256)
print("RESULT", [o16.placements, o8.placements, lse8.placements, y.placements,
                 [t.placements for t in g]])
""")
    got = out.split("RESULT")[-1].strip()
    assert got == ("[(Shard(dim=0), Shard(dim=2)), (Shard(dim=0), Replicate()), "
                   "(Shard(dim=0), Replicate()), (Shard(dim=0), Shard(dim=2)), "
                   "[(Shard(dim=0), Shard(dim=2)), (Shard(dim=0), Partial(sum)), "
                   "(Shard(dim=0), Partial(sum)), (Shard(dim=0), Shard(dim=2)), "
                   "(Partial(sum), Shard(dim=0))]]")


def test_dryrun_cli_runs_a_full_cell(tmp_path):
    """gemma2-27b decode_32k on the 256-rank mesh, through the CLI; no card."""
    out_file = tmp_path / "rec.json"
    out = _child(f"""
from repro_torch.launch import dryrun
raise SystemExit(dryrun.main(["--arch", "gemma2-27b", "--shape", "decode_32k",
                              "--out", {str(out_file)!r}]))
""")
    assert "[OK ] gemma2-27b x decode_32k @ 16x16" in out
    (rec,) = json.loads(out_file.read_text())
    assert RECORD_KEYS <= set(rec) and rec["ok"] and rec["chips"] == 256
    assert rec["gflops_per_chip"] > 0 and rec["hbm_per_chip_gb"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["t_compute"] == pytest.approx(rec["gflops_per_chip"] * 1e9 / 989e12)


def test_report_tables_equal_the_jax_report(tmp_path):
    recs = []
    for i, (arch, shape, mesh) in enumerate([("llama3.2-1b", "train_4k", "16x16"),
                                             ("gemma2-27b", "decode_32k", "16x16"),
                                             ("kimi-k2-1t-a32b", "train_4k", "2x16x16")]):
        recs.append({"arch": arch, "shape": shape, "mesh": mesh, "ok": True,
                     "t_compute": 0.5 / (i + 1), "t_memory": 2e-3 * i, "t_collective": 3e-7,
                     "bottleneck": "compute", "hbm_per_chip_gb": 10.5 + i,
                     "useful_flops_ratio": 0.3, "roofline_frac": 0.9})
    recs.append({"arch": "xlstm-125m", "shape": "long_500k", "mesh": "16x16", "ok": False,
                 "error": "RuntimeError: boom"})
    f = tmp_path / "recs.json"
    f.write_text(json.dumps(recs))
    got, want = report.load_records([str(f)]), jax_report.load_records([str(f)])
    for mesh in ("16x16", "2x16x16"):
        assert report.roofline_table(got, mesh) == jax_report.roofline_table(want, mesh)
    assert report.failures(got) == jax_report.failures(want)


# --- the custom ops ---------------------------------------------------------

def _ssd_inputs(b=1, s=40, h=3, dh=8, n=5):
    g = torch.Generator().manual_seed(0)
    xs, bm, cm = (torch.randn(sh, generator=g) for sh in ((b, s, h, dh), (b, s, n), (b, s, n)))
    dt = torch.rand((b, s, h), generator=g) * 0.1
    return xs, bm, cm, dt, -torch.rand(h, generator=g)


def _flash_inputs(b=2, s=24, h=4, kh=2, hd=8):
    g = torch.Generator().manual_seed(0)
    return tuple(torch.randn(sh, generator=g) for sh in ((b, s, h, hd), (b, s, kh, hd),
                                                          (b, s, kh, hd)))


def _op_cases():
    q, k, v = _flash_inputs()
    o, lse = flash_ops.flash_attention_fwd_lse(q, k, v, True, 5, 0.0)
    ssd = _ssd_inputs()
    return {
        "flash_attention_fwd": (flash_ops.flash_attention_fwd, (q, k, v, True, 5, 30.0)),
        "flash_attention_fwd_lse": (flash_ops.flash_attention_fwd_lse, (q, k, v, False, 0, 0.0)),
        "flash_attention_bwd": (flash_ops.flash_attention_bwd,
                                (q, k, v, o, lse, torch.randn_like(o), True, 0, 0.0)),
        "ssd_chunked_fwd": (ssd_ops.ssd_chunked_fwd, (*ssd, 8)),
        "ssd_chunked_bwd": (ssd_ops.ssd_chunked_bwd, (*ssd, torch.randn_like(ssd[0]), 8)),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_fake_outputs_match_the_plain_version(name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args = _op_cases()[name]
    want = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        got = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in want]
    meta = op(*(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args))
    meta = meta if isinstance(meta, tuple) else (meta,)
    assert [(tuple(t.shape), t.dtype, t.is_contiguous()) for t in meta] == [
        (tuple(t.shape), t.dtype, True) for t in want]


def _live_loop(s, causal, window):
    """chip_smoke.py's count of live pairs before it moved to kernels/costs.py."""
    if not causal:
        return s * s
    return s * (s + 1) // 2 if window <= 0 else sum(min(i + 1, window) for i in range(s))


def _ssd_flops_loop(b, s, h, dh, n, q):
    """chip_smoke.py's ssd_flops before it moved to kernels/costs.py."""
    per_head = 0
    for t0 in range(0, s, q):
        r = min(q, s - t0)
        per_head += r * (r + 1) * (n + dh) + 4 * r * n * dh + n * dh
    return b * h * per_head


def _ssd_bwd_flops_loop(b, s, h, dh, n, q):
    """chip_smoke.py's ssd_bwd_flops before it moved to kernels/costs.py."""
    per_head, shared = 0, 0
    for t0 in range(0, s, q):
        r = min(q, s - t0)
        per_head += r * (r + 1) * (2 * dh + 2 * n) + 10 * r * dh * n + 2 * dh * n
        shared += r * (r + 1) * n
    return b * (h * per_head + shared)


@pytest.mark.parametrize("s, causal, window", [(8192, True, 0), (8192, True, 4096),
                                               (4096, False, 0), (1999, True, 512), (5, True, 7)])
def test_flash_costs_are_the_bound_counts(s, causal, window):
    b, h, kh, hd = 2, 32, 16, 128
    assert costs.live_pairs(s, causal=causal, window=window) == _live_loop(s, causal, window)
    q = torch.empty(b, s, h, hd, device="meta")
    k = torch.empty(b, s, kh, hd, device="meta")
    live = _live_loop(s, causal, window)
    fwd = OP_COSTS[torch.ops.repro_torch.flash_attention_fwd.default]
    assert fwd(q, k, k, causal, window, 0.0) == (4 * hd * live * b * h,
                                                 (q.numel() * 2 + k.numel() * 2) * 4)
    lse = torch.empty(b, h, s, device="meta")
    bwd = OP_COSTS[torch.ops.repro_torch.flash_attention_bwd.default]
    assert bwd(q, k, k, q, lse, q, causal, window, 0.0) == (
        10 * hd * live * b * h, (4 * q.numel() + 4 * k.numel() + lse.numel()) * 4)


@pytest.mark.parametrize("b, s, h, dh, n", [(4, 8192, 80, 64, 64), (4, 4096, 80, 64, 64),
                                            (1, 1000, 9, 22, 37)])
def test_ssd_costs_are_the_bound_counts(b, s, h, dh, n):
    for q in (1, 4, 8, 64, 256):
        assert costs.ssd_flops(b, s, h, dh, n, q) == _ssd_flops_loop(b, s, h, dh, n, q)
        assert costs.ssd_bwd_flops(b, s, h, dh, n, q) == _ssd_bwd_flops_loop(b, s, h, dh, n, q)
    args = [torch.empty(sh, device="meta") for sh in ((b, s, h, dh), (b, s, n), (b, s, n),
                                                       (b, s, h), (h,))]
    q_min = min((2 ** k for k in range(s.bit_length())),
                key=lambda c: _ssd_flops_loop(b, s, h, dh, n, c))
    fwd = OP_COSTS[torch.ops.repro_torch.ssd_chunked_fwd.default]
    assert fwd(*args, 256) == (_ssd_flops_loop(b, s, h, dh, n, q_min),
                               (sum(t.numel() for t in args) + args[0].numel()) * 4)
    q_min = min((2 ** k for k in range(s.bit_length())),
                key=lambda c: _ssd_bwd_flops_loop(b, s, h, dh, n, c))
    bwd = OP_COSTS[torch.ops.repro_torch.ssd_chunked_bwd.default]
    assert bwd(*args, args[0], 256) == (
        _ssd_bwd_flops_loop(b, s, h, dh, n, q_min),
        (3 * args[0].numel() + 4 * args[1].numel() + 2 * args[3].numel() + 2 * h) * 4)


def test_op_cost_counts_a_custom_op_by_its_registered_cost():
    q, k, v = _flash_inputs()
    with OpCostMode() as counter:
        flash_ops.flash_attention_fwd(q, k, v, True, 0, 0.0)
    c = counter.result()
    assert c.flops_by_op == {"repro_torch.flash_attention_fwd": 4 * 8 * 300 * 2 * 4}
    assert c.bytes == (q.numel() * 2 + k.numel() * 2) * 4


# --- meshes -----------------------------------------------------------------

def test_meshes():
    out = _child("""
import torch.distributed as dist
from repro_torch.launch import mesh
m = mesh.make_production_mesh(multi_pod=True)
print("RESULT", tuple(m.shape), m.mesh_dim_names, m.device_type)
try:
    mesh.make_production_mesh()
except RuntimeError as e:
    print("REFUSED", "already running" in str(e))
dist.destroy_process_group()
t = mesh.make_test_mesh(device="cpu")
print("TEST", tuple(t.shape), t.mesh_dim_names, t.device_type)
dist.destroy_process_group()
try:
    mesh.make_test_mesh()
except RuntimeError as e:
    print("NOCARD", "no CUDA device" in str(e))
""")
    assert "RESULT (2, 16, 16) ('pod', 'data', 'model') cuda" in out
    assert "REFUSED True" in out
    assert "TEST (1, 1) ('data', 'model') cpu" in out
    assert "NOCARD True" in out
