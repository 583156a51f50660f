"""The f32 products' roofline reader against a hand count."""

from __future__ import annotations

import pytest

from seifer_bench.lib import bench, costs


def test_f32_gemm_reader_counts_three_tf32_passes_against_its_kernel():
    reader = bench.load_module("metrics", "f32_gemm_roofline")
    assert reader.CALLS == ("repro_torch.kernels.gemm.ops:matmul_f32_cuda",)
    plane = ("tensor", (7680, 2560), 4)
    calls = [(reader.CALLS[0], (("tensor", (4, 8192, 2560), 4), plane, plane), {})] * 2
    # 2 m n k at 3 TF32 passes: 2 * 32768 * 7680 * 2560 * 3 / 495e12 s a call
    bound = 2 * 32768 * 7680 * 2560 * 3 / 495e12
    assert abs(reader.bound(calls[0]) - bound) < 1e-15
    assert costs.bound_s(4 * (32768 * 2560 + 2 * 7680 * 2560 + 32768 * 7680)) < bound
    ops = [("void (anonymous namespace)::seifer_gemm_tf32x3_kernel(CUtensorMap_st, ...)",
            0.0, 10000.0),
           ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8_stage3_w", 10000.0, 30000.0),
           ("void (anonymous namespace)::seifer_gemm_tf32x3_kernel(CUtensorMap_st, ...)",
            30000.0, 40000.0)]
    obs = {"calls": calls, "trace": [{"ops": ops, "labels": [], "window_us": (0.0, 4e4)}]}
    assert abs(reader.read(obs) - 100 * 2 * bound / 20e-3) < 1e-9
    assert reader.read({"calls": [], "trace": obs["trace"]}) is None


@pytest.mark.parametrize("module,found", [
    ("repro_torch.kernels.gemm.ops", True),
    ("repro_torch.kernels.no_such_package.ops", False),  # as in a program without the kernel
    ("no_such_program.kernels.gemm.ops", False),
])
def test_f32_gemm_reader_asks_the_import_system_for_the_kernel(module, found):
    reader = bench.load_module("metrics", "f32_gemm_roofline")
    assert reader._importable(module) is found
