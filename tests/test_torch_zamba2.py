"""Zamba2's layers (``core/model_zoo.zamba2_hybrid``) against the plain
reference of the benchmark (``seifer_bench/reference/zamba2.py``, written
from Hugging Face transformers' layer equations and importing nothing of
the port), on the CPU at small widths: d 256, Mamba2 heads of 64 with state
64 in 2 groups, attention heads of 128, seq 128.  Also the grouped scan's
plain version against the one-group one, the one-group paths and the old
head widths as they were, and the shared blocks held once.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.model_zoo import zamba2_hybrid
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssm_scan import ssd_chunked
from repro_torch.kernels.ssm_scan.ref import ssd_ref
from seifer_bench.reference import zamba2 as reference

WIDTHS = dict(d=256, d_in=512, mamba_heads=8, groups=2, state=64, conv=4, attn_heads=4,
              attn_head_dim=128, ffn=1024, adapter_rank=8, seq=128)
CUT = ("hybrid",) + ("mamba",) * 5 + ("hybrid",) + ("mamba",) * 5  # layers 11-22
# f32 on both sides, products in other orders: one layer agrees to ~2e-7
TOL_F32 = 1e-5


def _model(layer_types, hybrid_offset=1):
    return {**WIDTHS, "layer_types": list(layer_types), "hybrid_offset": hybrid_offset,
            "mem_blocks": 2, "chunk": 256, "rope_theta": 10000.0, "eps": 1e-5}


def _build(m, version=0):
    kw = {k: v for k, v in m.items() if k != "layer_types"}
    graph, ex = zamba2_hybrid(**kw, layer_types=tuple(m["layer_types"]), device="cpu")
    return graph, ex(version)


def _x(n=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, WIDTHS["seq"], 2 * WIDTHS["d"]), generator=gen)


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("kind", ["mamba", "hybrid"])
def test_one_layer_matches_the_reference(kind):
    """A Mamba2 layer, and a hybrid layer (shared block 1, its adapter and
    linear, then the Mamba2 layer), against the reference in f32."""
    m = _model((kind,))
    _, ex = _build(m)
    x = _x()
    with torch.no_grad():
        got = ex(0, 1, x)
    want = reference.forward(m, ex.params, x, [[0, 1]], 256)
    assert _rel(got, want) <= TOL_F32
    assert torch.equal(got[..., WIDTHS["d"]:], x[..., WIDTHS["d"]:])  # x0 passes unchanged
    if kind == "hybrid":
        assert ex.shared_calls == [0, 1]


def test_the_cut_served_through_deploy_with_int8_hops():
    """The twelve layers through ``deploy`` on the cell's cluster (each
    node's capacity the weights' bytes / 2.7): four stages, three int8
    hops carrying [h | x0].  The answers equal the executor's own chain
    through the same codec; against the reference (the round trip at each
    hop in plain torch) they agree but for int8 codes rounded the other way
    by the two sides' last-bit differences, which at these widths move a
    row by ~1e-3 and the scan carries to every later row: 2e-2."""
    import json
    from pathlib import Path

    from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
    from repro_torch.core.placement import CommGraph
    from repro_torch.dataplane.codecs import Int8Codec

    cfg = json.loads((Path(__file__).resolve().parents[1] / "seifer_bench" / "configs"
                      / "zamba2-7b-edge.json").read_text())
    m = _model(CUT)
    graph, _ = _build(m)
    cap = sum(layer.param_bytes for layer in graph.layers) / 2.7
    comm = CommGraph(bw=np.asarray(cfg["deployment"]["cluster"]["bw"], float),
                     node_capacity=np.asarray([-1.0] + [cap] * 6))
    kw = {k: v for k, v in m.items() if k != "layer_types"}
    graph, ex_for = zamba2_hybrid(**kw, layer_types=CUT, device="cpu")
    executors = []
    dep = deploy(DeploymentSpec(
        model=graph, executor_for_version=lambda v: executors.append(ex_for(v)) or executors[-1],
        cluster=ClusterSpec(comm=comm), codec="int8", serving="pipelined", queue_depth=2,
        microbatch=2, seed=3, device="cpu"))
    stages = [[p.partition.start, p.partition.stop] for p in dep.control.pipeline.pods]
    assert stages == cfg["deployment"]["stages"] == [[0, 3], [3, 6], [6, 9], [9, 12]]
    assert list(dep.plan.codecs) == ["identity", "int8", "int8", "int8", "identity"]
    x = _x()
    reqs = [dep.submit(x[i]) for i in range(2)]
    dep.drain()
    got = torch.stack([r.result for r in reqs])
    ex, codec = executors[-1], Int8Codec()
    chain = x
    with torch.no_grad():
        for j, (a, b) in enumerate(stages):
            chain = ex(a, b, codec.decode(codec.encode(chain)) if j else chain)
    assert _rel(got, chain) <= 1e-6
    assert _rel(got, reference.forward(m, ex.params, x, stages, 256)) <= 2e-2
    assert ex.shared_calls[0] >= 2 and ex.shared_calls[1] >= 2  # layers 17 and 11


def test_grouped_scan_ref_is_the_one_group_ref_per_group():
    """B and C in 2 groups: head h reads group h // (H / G); each group's
    heads come out as the one-group scan gives them from that group's B and
    C alone, and the op's CPU path is the plain version."""
    gen = torch.Generator().manual_seed(5)
    b, s, h, p, g, n = 2, 128, 8, 64, 2, 64
    xs = torch.randn((b, s, h, p), generator=gen) * 0.5
    bm, cm = (torch.randn((b, s, g, n), generator=gen) * 0.5 for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen) - 2)
    a = -torch.rand((h,), generator=gen) * 4 - 0.5
    y, _ = ssd_ref(xs, bm, cm, dt, a, chunk=64)
    r = h // g
    for q in range(g):
        hs = slice(q * r, (q + 1) * r)
        one, _ = ssd_ref(xs[:, :, hs], bm[:, :, q], cm[:, :, q], dt[:, :, hs], a[hs], chunk=64)
        torch.testing.assert_close(y[:, :, hs], one, rtol=1e-6, atol=1e-6)
    assert torch.equal(ssd_chunked(xs, bm, cm, dt, a, chunk=64), y)
    with pytest.raises(ValueError, match="groups"):
        ssd_ref(xs[:, :, :7], bm, cm, dt[..., :7], a[:7], chunk=64)
    with pytest.raises(ValueError, match="no backward"):
        ssd_chunked(xs.requires_grad_(), bm, cm, dt, a, chunk=64)


def test_one_group_and_the_old_head_widths_are_unchanged():
    """The LM zoo's one-group gate and split, and attention at the default
    scale, bit for bit as they were written before groups and scales."""
    from repro_torch.models import ssm

    gen = torch.Generator().manual_seed(6)
    d_in, n = 256, 64
    y, z = (torch.randn((2, 16, d_in), generator=gen) for _ in range(2))
    w = torch.rand((d_in,), generator=gen) + 0.5
    out_proj = torch.randn((d_in, 32), generator=gen)
    g = y.float() * ssm.silu(z.float())  # the one-group gate as it was written
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + 1e-6) * w.float()
    assert torch.equal(ssm._gate_out(None, {"norm_w": w, "out_proj": out_proj}, y, z),
                       (g.to(z.dtype) @ out_proj).to(z.dtype))
    xbc = torch.randn((2, 16, d_in + 2 * n), generator=gen)
    x, bm, cm = ssm.split_xbc(xbc, d_in, n)
    assert torch.equal(bm, xbc[..., d_in:d_in + n].float().contiguous())
    assert torch.equal(cm, xbc[..., d_in + n:].float().contiguous())
    assert torch.equal(x, xbc[..., :d_in])
    for hd in (8, 64, 80, 128, 256):
        q, k, v = (torch.randn((1, 40, 2, hd), generator=gen) for _ in range(3))
        plain = attention_ref(q, k, v, causal=True, softcap=50.0)
        assert torch.equal(flash_attention(q, k, v, causal=True, softcap=50.0), plain)
        assert torch.equal(attention_ref(q, k, v, causal=True, softcap=50.0, scale=hd**-0.5),
                           plain)
    q.requires_grad_()
    with pytest.raises(ValueError, match="forward only"):
        flash_attention(q, k, v, scale=0.5)


def test_the_shared_blocks_are_held_once():
    """Three hybrid layers over two blocks (0, 1, 0): the first and the last
    read the same tensors, which are the version's only copy; the layer
    graph counts a block's bytes on each hybrid layer that uses it."""
    m = _model(("hybrid", "mamba", "hybrid", "mamba", "hybrid"), hybrid_offset=0)
    graph, ex = _build(m)
    fns = ex.layer_fns
    assert fns[0].block is fns[4].block and fns[0].block is not fns[2].block
    assert fns[1].block is None
    for name in ("wqkv", "wo", "w_gu", "w_down", "attn_norm", "ffn_norm"):
        assert fns[0].block[name][0].data_ptr() == ex.params[name][0].data_ptr()
        assert fns[2].block[name][0].data_ptr() == ex.params[name][1].data_ptr()
        assert ex.params[name].shape[0] == 2
    assert ex.params["w_lin"].shape[0] == 3  # each hybrid layer's own
    sizes = [layer.param_bytes for layer in graph.layers]
    assert sizes[0] == sizes[2] == sizes[4] > sizes[1] == sizes[3]
    with torch.no_grad():
        ex(0, 5, _x(1))
    assert ex.shared_calls == [2, 1]


def test_the_engine_names_the_requests_a_stage_computes():
    """``PipelinedServingLoop.computing(start)``: while a stage's executor
    runs, the requests of its microbatch in row order; nothing otherwise."""
    from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
    from repro_torch.core.model_zoo import demo_mlp

    graph, ex_for = demo_mlp(d=8, n_layers=4, device="cpu")
    seen = []

    def executor_for_version(v):
        inner = ex_for(v)

        def executor(start, stop, x):
            ids = [q.req_id for q in dep.loop.computing(start)]
            assert len(ids) == x.shape[0]
            seen.append((start, ids))
            return inner(start, stop, x)

        executor.fused_codecs = inner.fused_codecs
        return executor

    dep = deploy(DeploymentSpec(
        model=graph, executor_for_version=executor_for_version,
        cluster=ClusterSpec(n_nodes=6, capacity_bytes=graph.total_param_bytes / 2.5, seed=5),
        serving="pipelined", microbatch=2, seed=3, device="cpu"))
    starts = [p.partition.start for p in dep.control.pipeline.pods]
    assert len(starts) > 1
    seen.clear()
    reqs = [dep.submit(torch.full((8,), float(i))) for i in range(6)]
    dep.drain()
    groups = [[r.req_id for r in reqs[i:i + 2]] for i in range(0, 6, 2)]
    for s in starts:
        assert [ids for start, ids in seen if start == s] == groups
    assert all(dep.loop.computing(s) == [] for s in starts)
