"""The port's chunked SSD scan (plain version, on the CPU) against the JAX
package's ``ssd_ref`` and its Pallas kernel in interpret mode, on the same
numpy inputs.

Pins: atol = rtol = 1e-5, the JAX package's own kernel-vs-ref pin
(``tests/test_kernels.py``).  The port sums the in-chunk cumsum in the order
XLA takes on the CPU (``ref.chunk_cumsum``), so only the products' f32 order
differs; another order alone would cost ~2x this pin at chunk 128.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import ssd_chunked as jax_ssd_chunked
from repro.kernels.ssm_scan.ref import ssd_ref as jax_ssd_ref
from repro_torch.kernels.ssm_scan import ssd_chunked
from repro_torch.kernels.ssm_scan.kernel import ssd_chunked_cuda
from repro_torch.kernels.ssm_scan.kernel import segments_for
from repro_torch.kernels.ssm_scan.ref import (
    chunk_cumsum,
    segment_starts,
    ssd_ref,
    ssd_ref_padded,
    ssd_ref_segmented,
)

# (b, s, h, dh, n, chunk): the JAX package's two kernel-test dims, and
# demo_ssm's default layer (S=8, one chunk)
DIMS = [(2, 256, 4, 64, 32, 64), (1, 512, 8, 64, 64, 128), (1, 8, 2, 12, 4, 8)]


def _inputs(b, s, h, dh, n, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((b, s, h, dh), dtype=np.float32) * 0.5
    bm = rng.standard_normal((b, s, n), dtype=np.float32) * 0.5
    cm = rng.standard_normal((b, s, n), dtype=np.float32) * 0.5
    dt = np.asarray(jax.nn.softplus(rng.standard_normal((b, s, h), dtype=np.float32)))
    a = -np.exp(rng.standard_normal((h,), dtype=np.float32) * 0.3)
    return xs, bm, cm, dt, a


def _torch(arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _slow_cases(dims):
    """Each case as it was, then again with dt x 0.01 (``-slow``): with the
    plain dt (softplus, a ~ -1) a chunk of 64 decays the carried state by
    ~e^-58, so ``state * exp(cum_last)`` is ~0 and the inter-chunk terms go
    untested; at dt / 100 the state reaches every later chunk."""
    return ([pytest.param(d, 1.0, id=f"dims{i}") for i, d in enumerate(dims)]
            + [pytest.param(d, 0.01, id=f"dims{i}-slow") for i, d in enumerate(dims)])


def _assert_close(got, want, what: str, case) -> None:
    """assert_allclose at the 1e-5 pin, naming the comparison and the case."""
    diff = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                               err_msg=f"{what} at {case}: max-abs {diff:.3g}")


@pytest.mark.parametrize("dims,dt_scale", _slow_cases(DIMS))
def test_plain_matches_jax_ref_and_pallas_interpret(dims, dt_scale):
    *shape, chunk = dims
    xs, bm, cm, dt, a = _inputs(*shape)
    arrays = (xs, bm, cm, dt * np.float32(dt_scale), a)
    y, state = ssd_ref(*_torch(arrays), chunk=chunk)
    y_ref, h_ref = jax_ssd_ref(*_jax(arrays), chunk=chunk)
    y_pal = jax_ssd_chunked(*_jax(arrays), chunk=chunk, use_pallas=True, interpret=True)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    case = (dims, dt_scale)
    _assert_close(y.numpy(), np.asarray(y_ref), "y vs the JAX ssd_ref", case)
    _assert_close(y.numpy(), np.asarray(y_pal), "y vs the JAX Pallas kernel (interpret)", case)
    _assert_close(state.numpy(), np.asarray(h_ref), "the final state vs ssd_ref's hT", case)


@pytest.mark.parametrize("dims", DIMS)
def test_dispatch_on_cpu_is_the_plain_version(dims):
    *shape, chunk = dims
    args = _torch(_inputs(*shape, seed=1))
    assert torch.equal(ssd_chunked(*args, chunk=chunk), ssd_ref(*args, chunk=chunk)[0])


def test_chunk_invariance():
    """The scan is chunk-invariant: 32 against 256 at the JAX package's 1e-4."""
    args = _torch(_inputs(1, 256, 2, 32, 16, seed=2))
    y1, _ = ssd_ref(*args, chunk=32)
    y2, _ = ssd_ref(*args, chunk=256)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-4, rtol=1e-4)


def test_padded_plain_version_is_the_plain_version_chunked_anew():
    """``ssd_ref_padded`` (the kernel's comparison on the card): exactly
    ``ssd_ref`` where no padding is needed; a ragged S chunked at 64 agrees
    with S chunked at 32 to the chunk-invariance pin."""
    args = _torch(_inputs(2, 128, 3, 16, 8, seed=5))
    assert torch.equal(ssd_ref_padded(*args, chunk=64), ssd_ref(*args, chunk=64)[0])
    ragged = [t[:, :96].contiguous() for t in args[:4]] + [args[4]]
    np.testing.assert_allclose(ssd_ref_padded(*ragged, chunk=64).numpy(),
                               ssd_ref(*ragged, chunk=32)[0].numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("length", [5, 16, 40, 700])
def test_chunk_cumsum_is_xlas_order(length):
    """Bit-identical to ``jnp.cumsum`` on the CPU, padded blocks included."""
    x = np.random.default_rng(length).standard_normal((2, length, 3)).astype(np.float32)
    got = chunk_cumsum(torch.from_numpy(x), 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)))


def test_upper_triangle_does_not_leak_nan():
    """Steep decays overflow exp(cum_t - cum_s) above the diagonal; the mask
    is applied before exp, so nothing of it reaches y."""
    xs, bm, cm, dt, _ = _torch(_inputs(1, 64, 2, 8, 4, seed=3))
    y, state = ssd_ref(xs, bm, cm, dt * 200.0, torch.tensor([-5.0, -0.5]), chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()


def test_indivisible_chunk_raises_the_jax_error():
    args = _torch(_inputs(1, 96, 2, 8, 4, seed=4))
    with pytest.raises(ValueError, match="seq 96 must divide chunk 64"):
        ssd_chunked(*args, chunk=64)
    with pytest.raises(ValueError, match="seq 96 must divide chunk 64"):
        jax_ssd_chunked(*_jax(_inputs(1, 96, 2, 8, 4, seed=4)), chunk=64,
                        use_pallas=True, interpret=True)


def test_kernel_wrapper_refuses_cpu_tensors():
    args = _torch(_inputs(1, 8, 2, 12, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunked_cuda(*args, chunk=8)
    assert ssd_chunked_cuda.launches == 0


def _max_rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("dims", [(2, 256, 4, 64, 32), (1, 200, 3, 16, 8), (2, 8, 2, 12, 4)])
def test_segmented_at_one_segment_is_the_padded_plain_version(dims):
    args = _torch(_inputs(*dims, seed=6))
    assert torch.equal(ssd_ref_segmented(*args, chunk=64, segments=1),
                       ssd_ref_padded(*args, chunk=64))


# (b, s, h, dh, n, segments): S=200 is ragged (4 chunks of 64, the last of
# 8 rows); P=3 over 4 chunks gives segments of 1, 1 and 2 chunks; P=nc
# makes every segment one chunk
SEGMENTED = [(2, 256, 4, 64, 32, 2), (1, 200, 3, 16, 8, 2), (1, 200, 3, 16, 8, 3),
             (1, 200, 3, 16, 8, 4), (2, 320, 2, 32, 16, 3), (1, 512, 2, 64, 64, 8)]


@pytest.mark.parametrize("slow", [False, True])
@pytest.mark.parametrize("dims", SEGMENTED)
def test_segmented_matches_plain_scan(dims, slow):
    """Folding the segments' end states moves where the state's decays are
    multiplied, not what is computed: within 1e-6 of max|y| of the plain
    scan.  With dt / 100 (``slow``) a chunk decays the state by ~e^-0.5, not
    ~e^-45, so the carried state reaches every later segment."""
    *shape, segments = dims
    xs, bm, cm, dt, a = _torch(_inputs(*shape, seed=7))
    args = (xs, bm, cm, dt * 0.01 if slow else dt, a)
    y = ssd_ref_segmented(*args, chunk=64, segments=segments)
    pad = -shape[1] % 64
    ref, _ = ssd_ref(*(torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in args[:4]), a, chunk=64)
    ref = ref[:, :shape[1]]
    assert y.shape == ref.shape and y.dtype == torch.float32
    assert _max_rel(y, ref) <= 1e-6


@pytest.mark.parametrize("dims,dt_scale", _slow_cases(
    [(2, 256, 4, 64, 32, 64, 2), (1, 512, 8, 64, 64, 128, 4), (1, 192, 2, 64, 16, 64, 3)]))
def test_segmented_matches_jax_ref_and_pallas_interpret(dims, dt_scale):
    *shape, chunk, segments = dims
    xs, bm, cm, dt, a = _inputs(*shape, seed=8)
    arrays = (xs, bm, cm, dt * np.float32(dt_scale), a)
    y = ssd_ref_segmented(*_torch(arrays), chunk=chunk, segments=segments).numpy()
    y_ref, _ = jax_ssd_ref(*_jax(arrays), chunk=chunk)
    y_pal = jax_ssd_chunked(*_jax(arrays), chunk=chunk, use_pallas=True, interpret=True)
    case = (dims, dt_scale)
    _assert_close(y, np.asarray(y_ref), "segmented y vs the JAX ssd_ref", case)
    _assert_close(y, np.asarray(y_pal), "segmented y vs the JAX Pallas kernel (interpret)", case)


def test_segmented_strong_decay_stays_finite():
    """dt x 200 drives every D_p to 0 and the state with it; nothing overflows."""
    xs, bm, cm, dt, _ = _torch(_inputs(1, 256, 2, 8, 4, seed=3))
    args = (xs, bm, cm, dt * 200.0, torch.tensor([-5.0, -0.5]))
    y = ssd_ref_segmented(*args, chunk=64, segments=4)
    assert torch.isfinite(y).all()
    assert _max_rel(y, ssd_ref_padded(*args, chunk=64)) <= 1e-6


def test_segment_starts():
    assert segment_starts(128, 8) == list(range(0, 129, 16))
    assert segment_starts(4, 3) == [0, 1, 2, 4]
    assert segment_starts(5, 5) == [0, 1, 2, 3, 4, 5]
    for bad in (0, 6):
        with pytest.raises(ValueError, match="segments"):
            segment_starts(5, bad)


@pytest.mark.parametrize("b,h,n_chunks,sms,want", [
    (4, 80, 128, 132, 2),     # the served layer: 640 blocks, 2.4 waves
    (1, 2, 1, 132, 1),        # one chunk: nothing to split
    (2, 2, 3, 132, 1),        # short sequence
    (1, 2, 512, 132, 128),    # few heads, long sequence: segments of 4 chunks
    (64, 80, 128, 132, 1),    # many sequences fill the card by themselves
])
def test_segments_for(b, h, n_chunks, sms, want):
    assert segments_for(b, h, n_chunks, sms) == want
