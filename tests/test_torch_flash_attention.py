"""The port's flash attention (its plain version, on the CPU) against the JAX
package's Pallas kernel in interpret mode and its naive ``attention_ref``.

Same seeded numpy inputs through both, f32, over causal x window x softcap
x GQA (G = 1, 2) sweeps.  Pin: 2e-5 max-abs, the JAX package's own f32
forward tolerance (sums over hd and keys taken in another order).
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_tpu
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

TOL = 2e-5
SWEEP = list(itertools.product([True, False], [0, 24], [0.0, 50.0], [1, 2]))


def _qkv(b, s, h, kh, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, kh, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, kh, hd), dtype=np.float32)
    return q, k, v


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


@pytest.mark.parametrize("causal,window,softcap,g", SWEEP)
def test_matches_pallas_interpret(causal, window, softcap, g):
    q, k, v = _qkv(2, 64, 2 * g, 2, 16, seed=len(SWEEP) + window + g)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, window=window, softcap=softcap)
    want = flash_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, window=window, softcap=softcap,
                               block_q=32, block_k=32, interpret=True)
    assert out.shape == q.shape and out.dtype == torch.float32
    assert _max_abs(out.numpy(), want) <= TOL


@pytest.mark.parametrize("causal,window,softcap,g", SWEEP)
def test_matches_jax_attention_ref(causal, window, softcap, g):
    q, k, v = _qkv(1, 40, 2 * g, 2, 8, seed=100 + window + g)
    out = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=causal, window=window, softcap=softcap)
    want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, softcap=softcap)
    assert _max_abs(out.numpy(), want) <= TOL


@pytest.mark.parametrize("q_offset", [0, 8])
def test_q_offset_matches_jax_ref(q_offset):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 8, 2, 8), dtype=np.float32)
    k = rng.standard_normal((1, 16, 1, 8), dtype=np.float32)
    out = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
                        q_offset=q_offset, window=6)
    want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                             q_offset=q_offset, window=6)
    assert _max_abs(out.numpy(), want) <= TOL


def test_mixed_devices_raise():
    q, k, v = (torch.zeros(1, 8, 2, 64) for _ in range(3))
    with pytest.raises(ValueError, match="cpu or all on cuda"):
        flash_attention(q, k.to("meta"), v)


def test_wgmma_launch_counter_in_counts_and_reset():
    """The forward's launches on the wgmma kernel (hd 64 to 128) are their
    own key of ``launch_counts()``, zeroed by ``reset_launch_counts()``."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.kernel import WGMMA_HEAD_DIMS, flash_attention_cuda

    assert WGMMA_HEAD_DIMS == (64, 80, 112, 128)
    flash_attention_cuda.launches_wgmma = 3
    assert launch_counts()["flash_attention_cuda_wgmma"] == 3
    reset_launch_counts()
    counts = launch_counts()
    assert counts["flash_attention_cuda_wgmma"] == 0 and counts["flash_attention_cuda"] == 0
