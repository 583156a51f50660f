from repro_torch.kernels.gemm.ops import matmul_f32, matmul_f32_ref, split_planes, weight_planes

__all__ = ["matmul_f32", "matmul_f32_ref", "split_planes", "weight_planes"]
