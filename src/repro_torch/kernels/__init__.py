"""Hand-written Hopper kernels of the port, each beside its plain version.

``quantize`` (int8 boundary codec: quantize, dequantize, fused
dequant-matmul), ``flash_attention`` (forward and backward) and
``ssm_scan`` (the chunked Mamba2 SSD scan, forward and backward).  CUDA sources live in
``csrc/`` and are built at the first CUDA call (``_build``).
"""

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.quantize.kernel import (
    dequant_matmul_cuda,
    dequantize_int8_cuda,
    quantize_int8_cuda,
)
from repro_torch.kernels.ssm_scan.kernel import ssd_chunked_bwd_cuda, ssd_chunked_cuda

# every kernel wrapper; each counts its launches in ``.launches``
KERNEL_WRAPPERS = (
    quantize_int8_cuda,
    dequantize_int8_cuda,
    dequant_matmul_cuda,
    flash_attention_cuda,
    flash_attention_bwd_cuda,
    ssd_chunked_cuda,
    ssd_chunked_bwd_cuda,
)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    flash_attention_cuda.launches_windowed = 0
    flash_attention_bwd_cuda.launches_windowed = 0


def launch_counts() -> dict[str, int]:
    """Launches of each wrapper, and of flash attention (forward and
    backward) with a sliding window apart (``flash_attention_cuda_windowed``,
    ``flash_attention_bwd_cuda_windowed``, also in the totals)."""
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    counts["flash_attention_cuda_windowed"] = flash_attention_cuda.launches_windowed
    counts["flash_attention_bwd_cuda_windowed"] = flash_attention_bwd_cuda.launches_windowed
    return counts
