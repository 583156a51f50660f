"""The frozen work counts against hand counts, and the arrival generator."""

from __future__ import annotations

import torch

from seifer_bench.lib import arrivals, costs
from seifer_bench.reference.models import to_tf32


def test_flash_counts_by_hand():
    # s=4 causal: 4 + 3 + 2 + 1 = 10 live pairs; 4 hd FLOPs a pair, b=2, h=3, hd=8
    assert costs.live_pairs(4) == 10
    assert costs.live_pairs(4, window=2) == 3 + 2 * 2
    assert costs.flash_fwd_flops(2, 4, 3, 8) == 4 * 8 * 10 * 2 * 3
    # q, o: 2*4*3*8; k, v: 2*4*1*8; f32
    assert costs.flash_fwd_bytes(2, 4, 3, 1, 8) == (2 * 2 * 4 * 3 * 8 + 2 * 2 * 4 * 1 * 8) * 4


def test_ssd_counts_by_hand():
    # one chunk of r=2 rows, n=dh=1: r(r+1)(n+dh) + 4 r n dh + n dh = 12 + 8 + 1
    assert costs.ssd_flops(1, 2, 1, 1, 1, 2) == 21
    # chunk 1: two chunks of one row: 2 * (1*2*2 + 4 + 1)
    assert costs.ssd_flops(1, 2, 1, 1, 1, 1) == 18
    flops, nbytes = costs.ssd_fwd_cost(1, 2, 1, 1, 1)
    assert flops == 18  # the cheaper chunking
    assert nbytes == (2 * 2 + 2 * 2 + 2 + 1) * 4


def test_codec_and_receive_counts_by_hand():
    # 512 f32 elements at block 256: read 4, write 1 a element, two f32 scales
    assert costs.quantize_bytes(512, 4, 256) == 512 * 5 + 8
    assert costs.dequantize_bytes(512, 4, 256) == 512 * 5 + 8
    flops, nbytes = costs.dequant_matmul_cost(3, 256, 5, 256)
    assert flops == 2 * 3 * 256 * 5
    assert nbytes == 3 * 256 + 4 * 3 + 4 * 256 * 5 + 4 * 3 * 5


def test_request_flops_by_hand():
    # demo_transformer d=4, 2 heads of 2, one kv head, mlp 2, s=3, one layer:
    # q|k|v 2*3*4*8, wo 2*3*4*4, MLP 2 * 2*3*4*8, attention 4*2*6 pairs*2 heads
    dense = 2 * 3 * 4 * 8 + 2 * 3 * 4 * 4 + 2 * (2 * 3 * 4 * 8)
    assert costs.demo_transformer_request_flops(4, 1, 3, 2, 1, 2) == dense + 4 * 2 * 6 * 2
    # demo_ssm d=4, 2 heads, state 1, s=2: projections 2*2*4*(2+2), scan at dh 2
    scan, _ = costs.ssd_fwd_cost(1, 2, 2, 2, 1)
    assert costs.demo_ssm_request_flops(4, 1, 2, 2, 1) == 2 * 2 * 4 * 4 + scan


def test_bound_takes_the_larger_term():
    assert costs.bound_s(3.35e12) == 1.0
    assert costs.bound_s(0, 495e12, costs.F32_PRODUCT_S_PER_FLOP) == 3.0


def test_stratified_poisson_offers_the_same_work_in_another_order():
    a = arrivals.arrival_times("poisson-stratified", rate=50, duration_s=4, seed=2**31 + 1)
    b = arrivals.arrival_times("poisson-stratified", rate=50, duration_s=4, seed=2**31 + 2)
    assert len(a) == len(b) == 200
    assert a != b and a[-1] < 4 and b[-1] < 4
    gaps = lambda t: sorted(round(y - x, 9) for x, y in zip([0.0] + t, t))  # noqa: E731
    assert gaps(a) == gaps(b)
    assert arrivals.arrival_times("poisson", rate=50, duration_s=4, seed=3) == \
        arrivals.arrival_times("poisson", rate=50, duration_s=4, seed=3)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -(1.0 + 2**-11), 3.0])
    assert to_tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-10), 3.0]


def test_a_roofline_reader_counts_its_calls_against_its_kernels():
    from seifer_bench.lib import bench

    reader = bench.load_module("metrics", "int8_codec_roofline.open")
    x = ("tensor", (4, 8192, 5120), 4)
    calls = [(reader.CALLS[0], (x,), {"block": 256}),
             (reader.CALLS[1], (("tensor", (4, 8192, 5120), 1), ("tensor", (4, 8192, 20), 4)),
              {"dtype": "torch.float32", "block": 256})]
    bound = 2 * costs.bound_s(costs.quantize_bytes(4 * 8192 * 5120, 4, 256))
    ops = [("void (anonymous namespace)::quantize_int8_kernel<float>(float const*)", 0.0, 500.0),
           ("void (anonymous namespace)::dequantize_int8_vec_kernel<float>(...)", 600.0, 1100.0),
           ("ssd_scan_kernel<true, true>", 1200.0, 9000.0)]
    obs = {"calls": calls, "trace": [{"ops": ops, "labels": [], "window_us": (0.0, 1e4)}]}
    assert abs(reader.read(obs) - 100 * bound / 1e-3) < 1e-9
    assert reader.read({"calls": [], "trace": obs["trace"]}) is None
    idle = bench.load_module("metrics", "idle_pct.open").read(obs)
    assert abs(idle - 100 * (1 - (0.5e-3 + 0.5e-3 + 7.8e-3) / 1e-2)) < 1e-9
