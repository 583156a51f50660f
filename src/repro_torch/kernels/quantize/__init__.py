from repro_torch.kernels.quantize.ops import dequant_matmul, dequantize_int8, quantize_int8
from repro_torch.kernels.quantize.ref import INT8_MAX_REL_ERROR

__all__ = ["INT8_MAX_REL_ERROR", "dequant_matmul", "dequantize_int8", "quantize_int8"]
