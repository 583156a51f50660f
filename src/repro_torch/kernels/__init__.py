"""Hand-written Hopper kernels of the port, each beside its plain version.

``quantize`` (int8 boundary codec: quantize, dequantize, fused
dequant-matmul), ``flash_attention`` (forward and backward) and
``ssm_scan`` (the chunked Mamba2 SSD scan, forward and backward) and
``gemm`` (demo_transformer's f32 products on split-TF32 ``wgmma``).  CUDA sources live in
``csrc/`` and are built at the first CUDA call (``_build``).
"""

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.gemm.kernel import matmul_f32_cuda
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
    matmul_f32_cuda,
)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    flash_attention_cuda.launches_windowed = 0
    flash_attention_cuda.launches_wgmma = 0
    flash_attention_bwd_cuda.launches_windowed = 0
    ssd_chunked_cuda.launches_grouped = 0


def launch_counts() -> dict[str, int]:
    """Launches of each wrapper, and of flash attention (forward and
    backward) with a sliding window apart (``flash_attention_cuda_windowed``,
    ``flash_attention_bwd_cuda_windowed``), the forward on its ``wgmma``
    kernel (``flash_attention_cuda_wgmma``: hd 64 to 128) and the SSD scan
    with grouped B and C (``ssd_chunked_cuda_grouped``), each also in its
    total."""
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    counts["flash_attention_cuda_windowed"] = flash_attention_cuda.launches_windowed
    counts["flash_attention_cuda_wgmma"] = flash_attention_cuda.launches_wgmma
    counts["flash_attention_bwd_cuda_windowed"] = flash_attention_bwd_cuda.launches_windowed
    counts["ssd_chunked_cuda_grouped"] = ssd_chunked_cuda.launches_grouped
    return counts
