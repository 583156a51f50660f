"""The share of the device's operation time in the closed-loop cells spent
in operations that are none of the port's own CUDA kernels (the split-TF32
GEMM, flash attention, the SSD scan, the int8 codec and the fused receive):
torch's elementwise and reduction kernels, copies and sets.  Summed
operation durations, the mean over the ranks traced.  It moves
``req_per_s``."""

from seifer_bench.lib import trace

PORT_KERNELS = (r"seifer_gemm_tf32x3", r"flash_(fwd|bwd)", r"ssd_(scan|bwd)", r"quantize_int8",
                r"dequant_matmul")


def read(obs):
    shares = []
    for d in obs.get("trace", ()):
        total = sum(t1 - t0 for _, t0, t1 in d["ops"])
        if total > 0:
            own = 1e6 * trace.op_seconds(d, PORT_KERNELS)
            shares.append(1.0 - own / total)
    return 100.0 * sum(shares) / len(shares) if shares else None
