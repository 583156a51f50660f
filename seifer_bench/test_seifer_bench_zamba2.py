"""The Zamba2 cell (``zamba2-edge-closed``): its frozen counts by hand, a
tiny run on the CPU printing every result key, planted faults and the TF32
control that read not ``correct``, and its two new readers on made-up
traces.

The tiny cell keeps the configured cell's layers, cut, stages, traffic and
code paths at widths the CPU runs in seconds (d 256, Mamba2 heads of 64 with
state 64 in 2 groups, attention heads of 128, seq 128), each edge node's
capacity scaled by the weights' bytes so that the planner cuts the same
four stages.  Its limits are its own, set as the configured cell's are
between two readings at these widths: the program's stages and hops, held
one by one to the reference, read ~2.5e-7 (``rel_err``) and ~5e-7
(``row_med``) on the CPU, the reference with TF32 products ~4e-4 and
~1.3e-3, a planted fault 1e-1 and more.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math

import pytest

from seifer_bench import run
from seifer_bench.entries import zamba2 as entry
from seifer_bench.lib import bench, costs, zamba2_costs

TINY = {"d": 256, "d_in": 512, "mamba_heads": 8, "groups": 2, "state": 64, "attn_heads": 4,
        "attn_head_dim": 128, "ffn": 1024, "adapter_rank": 8, "seq": 128}
TINY_LIMITS = {"rel_err": 1e-5, "row_med": 2.5e-5}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _weight_bytes(m: dict) -> int:
    spec = entry.shapes(m)
    by = {kind: 4 * sum(math.prod(shape) for shape, _ in names.values())
          for kind, names in spec.items()}
    hybrids = m["layer_types"].count("hybrid")
    return len(m["layer_types"]) * by["mamba"] + hybrids * (by["block"] + by["hybrid"])


def tiny_cell():
    cell = bench.cell("zamba2-edge-closed")
    cfg = copy.deepcopy(cell.config)
    full = _weight_bytes(cfg["model"])
    cfg["model"].update(TINY)
    scale = _weight_bytes(cfg["model"]) / full
    cluster = cfg["deployment"]["cluster"]
    cluster["capacity"] = [c if c < 0 else c * scale for c in cluster["capacity"]]
    cfg["limits"] = TINY_LIMITS
    traffic = {**cell.traffic, "pool": 4, "compare": 4, "compare_first": 8}
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


def test_the_frozen_counts_by_hand():
    m = bench.config("zamba2-7b-edge")["model"]
    # a Mamba2 layer's products a token: W_in 3584 x (7168 + 7424 + 112), W_out 7168 x 3584
    assert zamba2_costs.mixer_product_flops(m) == 4096 * 2 * (3584 * 14704 + 7168 * 3584)
    # a shared block's a token: q|k|v 7168 x 21504, o 7168 x 3584, gate|up 3584 x 28672,
    # the adapter 3584 x 128 and 128 x 28672, down 14336 x 3584, the linear 3584 x 3584
    per_token = (7168 * 21504 + 7168 * 3584 + 3584 * 28672 + 3584 * 128 + 128 * 28672
                 + 14336 * 3584 + 3584 * 3584)
    assert zamba2_costs.shared_product_flops(m) == 4096 * 2 * per_token
    assert round(per_token * 2 / 1e6) == 702 and round(4096 * 2 * 3584 * 14704 / 4096e6) == 105
    # the grouped scan, by hand: S 4, chunk 2, H 2, dh 1, N 1, one group: a chunk's
    # C B^T 2 * 3 * 1, per head 2 * 3 * 1 + 4 * 2 + 1: (6 + 2 * 15) * 2 chunks
    assert zamba2_costs.ssd_grouped_flops(1, 4, 2, 1, 1, 1, 2) == 72
    # C B^T once a group: 2 groups of 56 heads need less than a gram a head
    one_each = costs.ssd_flops(4, 4096, 112, 64, 64, 64)
    grouped = zamba2_costs.ssd_grouped_flops(4, 4096, 112, 64, 64, 2, 64)
    assert one_each - grouped == 4 * 64 * (112 - 2) * 64 * 65 * 64
    flops, nbytes = zamba2_costs.ssd_grouped_cost(4, 4096, 112, 64, 64, 2)
    assert nbytes == 4 * (2 * 4 * 4096 * 112 * 64 + 2 * 4 * 4096 * 2 * 64 + 4 * 4096 * 112 + 112)
    assert flops <= grouped
    assert zamba2_costs.ssd_grouped_bound_s(4, 4096, 112, 64, 64, 2) == max(
        nbytes / costs.HBM_BYTES_PER_S, flops * 3 / costs.PEAK_TF32)
    attn = costs.flash_fwd_flops(1, 4096, 32, 224)
    scan, _ = zamba2_costs.ssd_grouped_cost(1, 4096, 112, 64, 64, 2)
    assert zamba2_costs.request_flops(m) == (12 * (zamba2_costs.mixer_product_flops(m) + scan)
                                             + 2 * (4096 * 2 * per_token + attn))


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_prints_every_result_key(trace):
    cell = tiny_cell()
    line, notes = run.measure(cell, seed=2**31 + 17, seconds=0.6, trace=trace, device="cpu",
                              t_start=0.0)
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"rel_err", "row_med"}
    json.loads(json.dumps(line))
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    if trace:
        assert {"mamba2_scan_roofline", "elementwise_pct.closed"} <= {
            m["name"] for m in cell.per_layer}
        assert set(line["metrics"]) <= names
        assert not any(n.endswith("_roofline") for n in line["metrics"])  # no device here
    else:
        assert set(line["metrics"]) == names == {"req_per_s", "setup_s"}
    assert any(n.startswith("a microbatch: ") and "shared_block_calls [1.0, 1.0]" in n
               for n in notes), notes


def _x0_dropped(make):
    def wrapped(layer_fns):
        ex = make(layer_fns)

        def executor(start, stop, x):
            if start > 0:  # every hop delivers h alone, x0 zeroed
                x = x.decode() if hasattr(x, "decode") else x
                x = x.clone()
                x[..., x.shape[-1] // 2:] = 0.0
            return ex(start, stop, x)

        executor.fused_codecs = ex.fused_codecs
        return executor

    return wrapped


def _one_group_for_every_head(split):
    def wrapped(xbc, d_in, n, n_groups=1):
        x, bm, cm = split(xbc, d_in, n, n_groups)
        if n_groups > 1:
            bm = bm[..., :1, :].expand_as(bm).contiguous()
        return x, bm, cm

    return wrapped


def _x0_dropped_on_the_wire(transcode):
    def wrapped(self, x):
        x = transcode(self, x).clone()
        x[..., x.shape[-1] // 2:] = 0.0
        return x

    return wrapped


@pytest.mark.parametrize("fault", ["x0_dropped", "one_group_for_every_head",
                                   "x0_dropped_on_the_wire"])
def test_a_planted_fault_reads_not_correct(monkeypatch, fault):
    import repro_torch.models.ssm as ssm
    import repro_torch.runtime.pipeline as pipeline
    from repro_torch.dataplane.codecs import Int8Codec

    if fault == "x0_dropped":  # inside the stage: its output is held to the reference
        monkeypatch.setattr(pipeline, "make_layer_executor",
                            _x0_dropped(pipeline.make_layer_executor))
    elif fault == "x0_dropped_on_the_wire":  # an int8 hop: the receiver is held to the sender
        monkeypatch.setattr(Int8Codec, "transcode", _x0_dropped_on_the_wire(Int8Codec.transcode))
    else:
        monkeypatch.setattr(ssm, "split_xbc", _one_group_for_every_head(ssm.split_xbc))
    line, _ = run.measure(tiny_cell(), seed=2**31 + 23, seconds=0.6, trace=False, device="cpu",
                          t_start=0.0)
    assert line["correct"] is False, line["checks"]


def test_the_tf32_control_reads_not_correct_through_judge():
    """The reference with TF32 products, stage by stage with int8 hops,
    judged by the entry's ``judge`` as a run is: every hop reads 0 and
    every stage its products' rounding, past both limits."""
    from seifer_bench.tools import zamba2_control

    got = zamba2_control.control(tiny_cell(), 2**31 + 29, "cpu")
    assert got["correct"] is False
    assert all(got[k] > lim for k, lim in got["limits"].items()), got


def test_a_missing_stage_reads_infinitely_wrong():
    """A sampled request whose log lacks a stage, or whose answer never
    came, is not compared as if whole."""
    import torch

    cell = tiny_cell()
    cfg = cell.config
    m, dep = cfg["model"], cfg["deployment"]
    pool = torch.zeros((1, m["seq"], 2 * m["d"]))
    for log, kept in (({0: []}, {0: pool[0]}), ({}, {})):
        checks = entry.judge(cfg["limits"], m, dep, {}, pool, log, kept, {0})
        assert all(v == math.inf for _, v, _ in checks)


def test_a_program_without_the_model_fails_before_any_work(monkeypatch):
    from repro_torch.core import model_zoo

    monkeypatch.delattr(model_zoo, "zamba2_hybrid")
    with pytest.raises(bench.BenchError, match="zamba2_hybrid"):
        run.measure(tiny_cell(), seed=1, seconds=0.1, trace=False, device="cpu", t_start=0.0)


def _call(bm_shape):
    return ("repro_torch.kernels.ssm_scan.ops:ssd_chunked_cuda",
            (("tensor", (4, 4096, 112, 64), 4), ("tensor", bm_shape, 4)), {})


def test_the_scan_roofline_reads_grouped_launches_only():
    reader = bench.load_module("metrics", "mamba2_scan_roofline")
    ops = [("void (anonymous namespace)::ssd_scan_kernel<true, true>(...)", 0.0, 1000.0),
           ("ampere_sgemm", 1000.0, 5000.0)]
    trace = {"ops": ops, "labels": [], "window_us": (0.0, 5000.0), "wall_s": 0.005}
    grouped = _call((4, 4096, 2, 64))
    bound = zamba2_costs.ssd_grouped_bound_s(4, 4096, 112, 64, 64, 2)
    got = reader.read({"calls": [grouped, grouped, _call((4, 4096, 64))], "trace": [trace]})
    assert got == pytest.approx(100.0 * 2 * bound / 1e-3)
    assert reader.read({"calls": [_call((4, 4096, 64))], "trace": [trace]}) is None
    assert reader.read({"calls": [grouped], "trace": []}) is None


def test_the_elementwise_share_leaves_out_the_ports_kernels():
    reader = bench.load_module("metrics", "elementwise_pct.closed")
    ops = [("seifer_gemm_tf32x3_kernel", 0.0, 600.0), ("flash_fwd_kernel<224>", 600.0, 700.0),
           ("void (anonymous namespace)::ssd_scan_kernel<true, true>", 700.0, 750.0),
           ("dequantize_int8_vec_kernel", 750.0, 760.0), ("quantize_int8_kernel", 760.0, 770.0),
           ("elementwise_kernel<128, 4>", 770.0, 950.0), ("Memcpy DtoD", 950.0, 1000.0)]
    trace = {"ops": ops, "labels": [], "window_us": (0.0, 2000.0), "wall_s": 0.002}
    assert reader.read({"trace": [trace]}) == pytest.approx(23.0)
    assert reader.read({"trace": []}) is None
