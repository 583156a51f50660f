"""The port's SSD scan gradient on the CPU: the plain backward
(``ssm_scan.ref.ssd_backward_ref``) against autograd through the plain
forward, the op's ``SSDScan`` Function against ``jax.grad`` of the JAX
package's scan, and one Mamba2 layer's gradients against the JAX layer's.

Tolerances, as fractions of max|ref| per gradient:

- ``ssd_backward_ref`` against autograd through ``ssd_ref`` in f64: 1e-10
  (the formulas are exact; f64 rounding alone is ~1e-15).  In f32: 1e-5,
  dxs, dbm, dcm and ddt against f32 autograd (the same cum, bit for bit),
  da against the f64 gradient.  f32 autograd is no yardstick for da: it
  takes da as sum_s dda_s dt_s, which cancels terms |T| times larger than
  da (T the in-chunk sum of dt), where ``ssd_backward_ref`` sums pairwise;
  at dt x 10 autograd's da is 2e-4 off.
- The port's gradient against ``jax.grad`` of the JAX ``ssd_ref`` and of
  ``ssd_chunked(use_pallas=False)``: 1e-4, the JAX package's gradient
  tolerance; the chunkings 64 and 256 against each other alike.
- One Mamba2 layer (``mamba_forward``, f32 params) against ``jax.grad`` of
  the JAX layer, every param leaf and the input: 1e-4.
- The backward kernel's decomposition (``ssd_backward_ref_grouped``: whole
  state walks, dbm / dcm summed by head groups) against
  ``ssd_backward_ref_padded`` at the kernel's chunk: 1e-6 (the same math
  summed in other orders; f32 rounding alone is ~4e-7 here).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.ssm_scan.ops import ssd_chunked as jax_ssd_chunked
from repro.kernels.ssm_scan.ref import ssd_ref as jax_ssd_ref
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.kernels.ssm_scan import ssd_chunked
from repro_torch.kernels.ssm_scan.ops import SSDScan
from repro_torch.kernels.ssm_scan.kernel import KERNEL_CHUNK, ssd_chunked_bwd_cuda
from repro_torch.kernels.ssm_scan.ref import (
    ssd_backward_ref,
    ssd_backward_ref_grouped,
    ssd_backward_ref_padded,
    ssd_ref,
)
from repro_torch.models import ssm as tssm
from repro_torch.models.common import params_from_numpy

# (b, s, h, dh, n, chunk): tests/test_torch_ssm_scan.py's DIMS
DIMS = [(2, 256, 4, 64, 32, 64), (1, 512, 8, 64, 64, 128), (1, 8, 2, 12, 4, 8)]
NAMES = ("dxs", "dbm", "dcm", "ddt", "da")
# dt x 3 (a ~ -1): cum reaches ~-150 within a chunk of 64 (zamba2-like dt
# reach ~-58), so exp(cum) underflows in f32 and the upper triangle's
# exp(cum_t - cum_s) would overflow unmasked
STRONG = 3.0


def _cases():
    """DIMS at the plain dt and at dt x 0.01 (the state reaches every later
    chunk), and the first of DIMS at strong decay."""
    return ([pytest.param(d, 1.0, id=f"dims{i}") for i, d in enumerate(DIMS)]
            + [pytest.param(d, 0.01, id=f"dims{i}-slow") for i, d in enumerate(DIMS)]
            + [pytest.param(DIMS[0], STRONG, id="dims0-strong")])


def _inputs(b, s, h, dh, n, seed=0, dt_scale=1.0):
    """xs, bm, cm, dt, a as the forward tests draw them, and dy."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((b, s, h, dh), dtype=np.float32) * 0.5
    bm = rng.standard_normal((b, s, n), dtype=np.float32) * 0.5
    cm = rng.standard_normal((b, s, n), dtype=np.float32) * 0.5
    dt = np.asarray(jax.nn.softplus(rng.standard_normal((b, s, h), dtype=np.float32)))
    a = -np.exp(rng.standard_normal((h,), dtype=np.float32) * 0.3)
    dy = rng.standard_normal((b, s, h, dh), dtype=np.float32)
    return xs, bm, cm, (dt * np.float32(dt_scale)).astype(np.float32), a, dy


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(np.array(x)).to(dtype) for x in arrays]


def _rel(got, want) -> float:
    g = got.detach().double() if isinstance(got, torch.Tensor) else torch.from_numpy(
        np.asarray(got, np.float64))
    w = want.detach().double() if isinstance(want, torch.Tensor) else torch.from_numpy(
        np.asarray(want, np.float64))
    assert g.shape == w.shape, (g.shape, w.shape)
    return ((g - w).abs().max() / w.abs().max().clamp_min(1e-300)).item()


def _autograd(args, dy, chunk):
    """The five gradients by autograd through ``ssd_ref``."""
    ins = [t.clone().requires_grad_() for t in args]
    y, _ = ssd_ref(*ins, chunk=chunk)
    return torch.autograd.grad(y, ins, dy)


def _assert_all(got, want, tol, what):
    errs = {n: _rel(g, w) for n, g, w in zip(NAMES, got, want)}
    assert max(errs.values()) <= tol, f"{what}: {errs} of max|ref| > {tol}"


@pytest.mark.parametrize("dims,dt_scale", _cases())
def test_plain_backward_matches_autograd_through_plain_forward(dims, dt_scale):
    *shape, chunk = dims
    *args, dy = _torch(_inputs(*shape, dt_scale=dt_scale), torch.float64)
    exact = _autograd(args, dy, chunk)
    _assert_all(ssd_backward_ref(*args, dy, chunk=chunk), exact, 1e-10, f"f64 {dims}")
    args32, dy32 = [t.float() for t in args], dy.float()
    got32 = ssd_backward_ref(*args32, dy32, chunk=chunk)
    assert all(g.dtype == torch.float32 for g in got32)
    want32 = (*_autograd(args32, dy32, chunk)[:4], exact[4])
    _assert_all(got32, want32, 1e-5, f"f32 {dims} (da against the f64 gradient)")


def test_plain_backward_keeps_da_where_autograd_cancels():
    """At dt x 10, f32 autograd's da loses what the pairwise sum keeps."""
    *args, dy = _torch(_inputs(1, 128, 2, 16, 8, dt_scale=10.0), torch.float64)
    exact = _autograd(args, dy, 64)[4]
    pairwise = ssd_backward_ref(*(t.float() for t in args), dy.float(), chunk=64)[4]
    autograd32 = _autograd([t.float() for t in args], dy.float(), 64)[4]
    assert _rel(pairwise, exact) <= 1e-5
    assert _rel(autograd32, exact) > 5 * _rel(pairwise, exact)


@pytest.mark.parametrize("dims,dt_scale", _cases()[:6])
def test_port_gradient_matches_jax_grad(dims, dt_scale):
    """``ssd_chunked`` on CPU tensors that require grad runs ``SSDScan``;
    its five gradients against ``jax.grad`` of the JAX ``ssd_ref`` and of
    the JAX op's jnp path, from the same numpy inputs."""
    *shape, chunk = dims
    arrays = _inputs(*shape, seed=1, dt_scale=dt_scale)
    *args, dy = _torch(arrays)
    ins = [t.clone().requires_grad_() for t in args]
    y = ssd_chunked(*ins, chunk=chunk)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    got = torch.autograd.grad(y, ins, dy)
    jargs = [jnp.asarray(x) for x in arrays[:5]]
    jdy = jnp.asarray(arrays[5])

    def loss_ref(*t):
        return jnp.sum(jax_ssd_ref(*t, chunk=chunk)[0] * jdy)

    def loss_op(*t):
        return jnp.sum(jax_ssd_chunked(*t, chunk=chunk, use_pallas=False) * jdy)

    for what, fn in (("ssd_ref", loss_ref), ("ssd_chunked(use_pallas=False)", loss_op)):
        want = jax.jit(jax.grad(fn, argnums=tuple(range(5))))(*jargs)
        _assert_all(got, [np.asarray(w) for w in want], 1e-4, f"{what} {dims} x{dt_scale}")


def test_function_saves_only_its_inputs():
    """The forward keeps xs, bm, cm, dt and a, not y or the chunk states:
    a rematerialized layer holds nothing more than its inputs."""
    args = [t.requires_grad_() for t in _torch(_inputs(1, 64, 2, 16, 8, seed=2)[:5])]
    y = ssd_chunked(*args, chunk=32)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 5
    assert all(s.data_ptr() == t.data_ptr() for s, t in zip(saved, args))
    with torch.no_grad():
        assert ssd_chunked(*args, chunk=32).grad_fn is None


def test_chunkings_agree():
    """The plain backward at chunk 64 against chunk 256 (the chunk
    ``mamba_forward`` asks for), and at 64 padded for a ragged S."""
    *args, dy = _torch(_inputs(2, 512, 3, 32, 16, seed=5))
    _assert_all(ssd_backward_ref(*args, dy, chunk=64), ssd_backward_ref(*args, dy, chunk=256),
                1e-4, "chunk 64 vs 256")
    part = [t[:, :200].contiguous() for t in (*args[:4], dy)]
    _assert_all(ssd_backward_ref_padded(*part[:4], args[4], part[4], chunk=64),
                ssd_backward_ref(*part[:4], args[4], part[4], chunk=200), 1e-4,
                "ragged S=200 padded at 64 vs chunk 200")


def test_mamba_layer_gradients_match_jax():
    """One Mamba2 layer of reduced zamba2 (d=64, 2 heads of 64, N=16) at
    S=512 and chunk 64, its f32 init params carried across leaf for leaf:
    the gradient of sum(out * w) in every param and in the input.  At the
    model's chunk of 256 the JAX gradient is NaN (its mask is applied after
    exp, and exp(cum_t - cum_s) above the diagonal overflows once a chunk
    decays by more than 88; 0 * inf in the VJP), so the layer runs at 64."""
    jcfg = jconfigs.reduced(jconfigs.ARCHS["zamba2-2.7b"])
    tcfg = tconfigs.reduced(tconfigs.ARCHS["zamba2-2.7b"])
    jp = jax.tree.map(lambda x: x.astype(jnp.float32), jssm.init_mamba(jcfg, jax.random.PRNGKey(7)))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 512, jcfg.d_model), dtype=np.float32)
    w = rng.standard_normal((2, 512, jcfg.d_model), dtype=np.float32)

    def jloss(p, xin):
        return jnp.sum(jssm.mamba_forward(jcfg, p, xin, chunk=64) * w)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in
          params_from_numpy(jax.tree.map(np.asarray, jp), "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    (tssm.mamba_forward(tcfg, tp, tx, chunk=64) * torch.from_numpy(w)).sum().backward()
    errs = {k: _rel(tp[k].grad, np.asarray(jg[k])) for k in sorted(jg)}
    errs["x"] = _rel(tx.grad, np.asarray(jgx))
    assert max(errs.values()) <= 1e-4, errs


GROUPED = [  # (b, s, h, dh, n, dt scale)
    (2, 256, 4, 64, 32, 0.01), (2, 256, 4, 64, 32, 1.0),
    (1, 1000, 3, 22, 37, 0.01),   # ragged: 16 chunks, the last of 40 rows
    (1, 1000, 3, 22, 37, 1.0),
    (1, 200, 2, 16, 8, 0.01),     # the last chunk ragged
    (1, 40, 3, 64, 64, 1.0),      # one ragged chunk
    (1, 256, 10, 64, 64, 0.01),   # a full head group and a short one
    (1, 512, 2, 64, 16, 200.0),   # strong decay
]


@pytest.mark.parametrize("b,s,h,dh,n,dt_scale", GROUPED)
def test_grouped_backward_matches_the_plain_backward(b, s, h, dh, n, dt_scale):
    """The backward kernel's decomposition at its chunk: both state walks
    whole, every chunk's gradients from its h and dH, dbm / dcm summed by
    groups of 8 heads; dt / 100 lets every carried state and dH reach every
    later (earlier) chunk."""
    *args, dy = _torch(_inputs(b, s, h, dh, n, seed=40 + h, dt_scale=dt_scale))
    if dt_scale == 200.0:
        args[4] = torch.tensor([-5.0, -0.5])
    want = ssd_backward_ref_padded(*args, dy, chunk=KERNEL_CHUNK)
    got = ssd_backward_ref_grouped(*args, dy, chunk=KERNEL_CHUNK, group=8)
    assert all(g.shape == w.shape and g.dtype == torch.float32 for g, w in zip(got, want))
    _assert_all(got, want, 1e-6, f"{(b, s, h, dh, n)} x{dt_scale}")


@pytest.mark.parametrize("h", [3, 80])
def test_head_grouped_sums_equal_the_per_head_sums(h):
    """dbm and dcm summed over groups of 8 heads (a short group at H=3, ten
    full ones at 80), in head order within a group and in group order
    after, against the plain backward's sum over all heads at once; the
    other gradients do not depend on the grouping."""
    *args, dy = _torch(_inputs(1, 192, h, 16, 16, seed=50 + h, dt_scale=0.01))
    want = ssd_backward_ref_padded(*args, dy, chunk=KERNEL_CHUNK)
    grouped = ssd_backward_ref_grouped(*args, dy, chunk=KERNEL_CHUNK, group=8)
    single = ssd_backward_ref_grouped(*args, dy, chunk=KERNEL_CHUNK, group=h)
    _assert_all(grouped, want, 1e-6, f"H={h}, groups of 8")
    for i in (0, 3, 4):
        assert torch.equal(grouped[i], single[i])
    for i in (1, 2):
        assert _rel(grouped[i], single[i]) <= 1e-6


def test_backward_kernel_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only: on the CPU it raises
    before anything is built (``SSDScan`` takes the plain backward there)."""
    *args, dy = _torch(_inputs(1, 64, 2, 16, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_chunked_bwd_cuda(*args, dy, chunk=64)
