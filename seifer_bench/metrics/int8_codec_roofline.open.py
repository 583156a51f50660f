"""The int8 codec's share of its roofline in the open-loop cell: the least time
of every quantize and dequantize launch in the window (bytes over HBM,
``lib/readers.codec_bound``) over the device time of their kernels.  It
moves ``p95_ms``."""

from seifer_bench.lib.readers import codec_bound, roofline

CALLS = ("repro_torch.kernels.quantize.ops:quantize_int8_cuda",
         "repro_torch.kernels.quantize.ops:dequantize_int8_cuda")
PATTERNS = (r"(?<!de)quantize_int8_kernel", r"dequantize_int8(_vec)?_kernel")


def read(obs):
    return roofline(obs, CALLS, PATTERNS, codec_bound)
