"""Wrappers of the CUDA chunked SSD scan kernels: the forward
(``csrc/ssd_scan.cu``) and the backward (``csrc/ssd_scan_bwd.cu``).

Checks what the kernel takes and raises on anything else: contiguous
float32 CUDA tensors xs (B, S, H, dh), bm and cm (B, S, N) or, in G groups,
(B, S, G, N) with H a multiple of G (head h reads group h // (H / G)), dt
(B, S, H), a (H,), with dh and N at most 64; the backward takes one group.
``chunk`` keeps the JAX package's precondition (``q = min(chunk, S)`` must
divide S, else ``ValueError``), but the kernel tiles at its own ``KERNEL_CHUNK`` rows whatever chunk the caller
asks for: the scan is chunk-invariant, and a Q x Q score tile at the
demo model's ``chunk=seq`` would not fit a block.  A ragged last chunk is
masked inside the kernel.  The output is a new (B, S, H, dh) f32 tensor;
the launch is counted in ``launches``, and one with grouped B and C also
in ``launches_grouped``.

Each (batch row, head) sequence is cut into ``segments`` segments of whole
chunks (``ref.segment_starts``), so that short work items fill the card:
``segments_for`` picks their number from the card's SM count unless the
caller forces it.  The C entry point runs two kernels: the first scans
every segment but the last from a zero state for its end state and decay,
into scratch the wrapper allocates here; the second folds those for its
segment's starting state and scans it.  ``ref.ssd_ref_segmented`` is the
same decomposition in plain PyTorch.

``ssd_chunked_bwd_cuda`` takes the same tensors and dy (B, S, H, dh), under
the same checks, and returns (dxs, dbm, dcm, ddt, da), new f32 tensors.  It
tiles at ``KERNEL_CHUNK`` too.  Its state pass walks each sequence whole in
both directions, and its chunk kernel takes ``HEAD_GROUP`` heads a block,
summing their shares of dbm and dcm.  The wrapper allocates the scratch
the four kernels share: the state entering and the gradient of the state
leaving every chunk, (B, H, nc, 64, 64) each; one share of dbm and of dcm
per head group, (B, S, ceil(H / HEAD_GROUP), N) each; and each chunk's
share of da.  At zamba2-2.7b's microbatch of 4 x 4096 (H=80, dh=N=64) that
is 0.755 GB (a partial per head took 1.34 GB).  One call is one launch in
``launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan.ref import chunk_of

KERNEL_CHUNK = 64  # rows per chunk inside the kernel (Q in ssd_scan.cu)
MAX_WIDTH = 64  # largest dh and N the kernel's shared tiles hold
BLOCKS_PER_SM = 2  # resident blocks of the folding (output) kernel on one SM
# the least waves of output blocks segments_for aims at: more segments fill
# the card more evenly but re-read xs and redo the state pass for all but
# the last; 2 waves (P=2 at demo_ssm's served layer) measured fastest
WAVES = 2
MIN_SEGMENT_CHUNKS = 4  # shorter segments cost more in folds than they gain
HEAD_GROUP = 8  # heads a block of the backward's chunk kernel takes (at most 8)


def segments_for(b: int, h: int, n_chunks: int, sms: int) -> int:
    """Segments per sequence: the least power of two that gives the B H P
    blocks ``WAVES`` waves on ``sms`` SMs, with segments of at least
    ``MIN_SEGMENT_CHUNKS`` chunks (so 1 for short sequences)."""
    want = -(-WAVES * BLOCKS_PER_SM * sms // max(1, b * h))
    cap = max(1, n_chunks // MIN_SEGMENT_CHUNKS)
    p = 1
    while p < want and 2 * p <= cap:
        p *= 2
    return p


def default_segments(b: int, s: int, h: int, device: torch.device) -> int:
    """The segments per sequence the wrapper takes on ``device`` unless told."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return segments_for(b, h, -(-s // KERNEL_CHUNK), sms)


def _require(t: torch.Tensor, name: str, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _require_scan(xs, bm, cm, dt, a, chunk: int, *,
                  grouped: bool = False) -> tuple[int, int, int, int, int, int]:
    """Check the scan's inputs as the kernels take them (bm and cm (B, S, G,
    N) too where ``grouped``); returns (B, S, H, dh, N, G)."""
    if xs.dim() != 4 or bm.dim() not in ((3, 4) if grouped else (3,)):
        raise ValueError(f"xs must be (B, S, H, dh) and bm (B, S, N)"
                         f"{' or (B, S, G, N)' if grouped else ''}, got "
                         f"{tuple(xs.shape)} / {tuple(bm.shape)}")
    b, s, h, dh = xs.shape
    n = bm.shape[-1]
    g = bm.shape[2] if bm.dim() == 4 else 1
    bc = (b, s, g, n) if bm.dim() == 4 else (b, s, n)
    if g < 1 or h % g:
        raise ValueError(f"heads {h} must be a multiple of the B / C groups {g}")
    for t, name, shape in ((xs, "xs", (b, s, h, dh)), (bm, "bm", bc),
                           (cm, "cm", bc), (dt, "dt", (b, s, h)),
                           (a, "a", (h,))):
        _require(t, name, shape)
    if s:
        chunk_of(s, chunk)
    if not (1 <= dh <= MAX_WIDTH and 1 <= n <= MAX_WIDTH):
        raise ValueError(f"kernel takes dh and N in 1..{MAX_WIDTH}, got dh={dh}, N={n}")
    if b > 65535 or h > 65535:
        raise ValueError("kernel grid takes at most 65535 batch rows and heads")
    return b, s, h, dh, n, g


def ssd_chunked_cuda(
    xs: torch.Tensor,  # (B, S, H, dh)
    bm: torch.Tensor,  # (B, S, N) or (B, S, G, N)
    cm: torch.Tensor,  # as bm
    dt: torch.Tensor,  # (B, S, H)
    a: torch.Tensor,  # (H,)
    *,
    chunk: int = 128,
    segments: int | None = None,
) -> torch.Tensor:
    b, s, h, dh, n, g = _require_scan(xs, bm, cm, dt, a, chunk, grouped=True)
    if segments is not None and segments < 1:
        raise ValueError(f"segments must be at least 1, got {segments}")
    n_chunks = -(-s // KERNEL_CHUNK)
    if segments is None:
        segments = default_segments(b, s, h, xs.device)
    p = max(1, min(segments, n_chunks))
    y = torch.empty((b, s, h, dh), dtype=torch.float32, device=xs.device)
    # end state (N x dh, padded to the kernel's 64 x 64) and decay of every
    # segment but the last, per sequence
    ends = torch.empty((b, h, p - 1, MAX_WIDTH, MAX_WIDTH), dtype=torch.float32,
                       device=xs.device)
    decays = torch.empty((b, h, p - 1), dtype=torch.float32, device=xs.device)
    if b and s and h:
        err = _build.lib().seifer_ssd_scan(
            xs.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(),
            a.data_ptr(), y.data_ptr(), ends.data_ptr(), decays.data_ptr(),
            b, s, h, dh, n, g, p, torch.cuda.current_stream(xs.device).cuda_stream)
        _build.check(err, "ssd_scan")
        ssd_chunked_cuda.launches += 1
        if bm.dim() == 4:
            ssd_chunked_cuda.launches_grouped += 1
    return y


ssd_chunked_cuda.launches = 0
ssd_chunked_cuda.launches_grouped = 0


def ssd_chunked_bwd_cuda(
    xs: torch.Tensor,  # (B, S, H, dh)
    bm: torch.Tensor,  # (B, S, N)
    cm: torch.Tensor,  # (B, S, N)
    dt: torch.Tensor,  # (B, S, H)
    a: torch.Tensor,  # (H,)
    dy: torch.Tensor,  # (B, S, H, dh)
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, ...]:
    """(dxs, dbm, dcm, ddt, da) of ``ssd_chunked_cuda``'s y, given dy."""
    b, s, h, dh, n, _ = _require_scan(xs, bm, cm, dt, a, chunk)
    _require(dy, "dy", (b, s, h, dh))
    nc = -(-s // KERNEL_CHUNK)
    dev = xs.device
    new = torch.empty if b and s and h else torch.zeros  # nothing to launch: zero gradients
    shapes = ((b, s, h, dh), (b, s, n), (b, s, n), (b, s, h), (h,))
    dxs, dbm, dcm, ddt, da = (new(sh, dtype=torch.float32, device=dev) for sh in shapes)
    if not (b and s and h):
        return dxs, dbm, dcm, ddt, da
    groups = -(-h // HEAD_GROUP)
    w = MAX_WIDTH
    states, dstates, dbp, dcp, dap = (
        torch.empty(sh, dtype=torch.float32, device=dev)
        for sh in ((b, h, nc, w, w), (b, h, nc, w, w), (b, s, groups, n), (b, s, groups, n),
                   (b, h, nc)))
    err = _build.lib().seifer_ssd_scan_bwd(
        xs.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(), a.data_ptr(),
        dy.data_ptr(), dxs.data_ptr(), dbm.data_ptr(), dcm.data_ptr(), ddt.data_ptr(),
        da.data_ptr(), states.data_ptr(), dstates.data_ptr(), dbp.data_ptr(), dcp.data_ptr(),
        dap.data_ptr(), b, s, h, dh, n, HEAD_GROUP, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ssd_scan_bwd")
    ssd_chunked_bwd_cuda.launches += 1
    return dxs, dbm, dcm, ddt, da


ssd_chunked_bwd_cuda.launches = 0
