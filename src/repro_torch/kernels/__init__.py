"""Hand-written Hopper kernels of the port, each beside its plain version.

``quantize`` (int8 boundary codec: quantize, dequantize, fused
dequant-matmul) and ``flash_attention`` (forward).  CUDA sources live in
``csrc/`` and are built at the first CUDA call (``_build``).
"""

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.quantize.kernel import (
    dequant_matmul_cuda,
    dequantize_int8_cuda,
    quantize_int8_cuda,
)

# every kernel wrapper; each counts its launches in ``.launches``
KERNEL_WRAPPERS = (
    quantize_int8_cuda,
    dequantize_int8_cuda,
    dequant_matmul_cuda,
    flash_attention_cuda,
)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
