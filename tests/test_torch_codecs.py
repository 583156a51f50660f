"""The port's data-plane codecs against the JAX package's.

The int8 transform: the same seeded numpy input through the JAX package's
``Int8Codec`` (on a jax array, its served path) and the port's (on a CPU
tensor): codes identical, scales equal, and the decode identical in f32.
The fp16 and topk-sparse transforms: the same input through both of the
JAX package's branches (jax array and numpy array) and the port's: the same
float16 bits and index set, and exactly equal decoded tensors.
The byte and cost model: ``wire_ratio``, ``compressed_bytes``, the error
bound and the flop rates equal for every registered codec name.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dataplane import get_codec as jax_get_codec
from repro.dataplane import list_codecs as jax_list_codecs
from repro_torch.dataplane import assign_link_codecs, get_codec, list_codecs
from repro_torch.dataplane.base import EncodedActivation


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def test_same_codec_names_and_default():
    assert list_codecs() == jax_list_codecs()
    assert list_codecs()[0] == "identity"


@pytest.mark.parametrize("shape", [(4, 256), (2, 16, 300), (3, 1000)])
def test_int8_encode_decode_match_jax(shape):
    x = _x(shape, sum(shape))
    kind, q, s, dtype = get_codec("int8").encode(torch.from_numpy(x))
    jkind, jq, js, jdtype = jax_get_codec("int8").encode(jnp.asarray(x))
    assert kind == "torch" and jkind == "jax"
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    y = get_codec("int8").decode((kind, q, s, dtype))
    jy = jax_get_codec("int8").decode((jkind, jq, js, jdtype))
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


@pytest.mark.parametrize("name", ["identity", "fp16", "int8", "topk-sparse"])
@pytest.mark.parametrize("shape", [(256, 32), (4, 7, 300)])
def test_byte_and_cost_model_match_jax(name, shape):
    c, jc = get_codec(name), jax_get_codec(name)
    for elem in (2.0, 4.0):
        assert c.wire_ratio(elem) == jc.wire_ratio(elem)
    assert c.wire_bytes(12345.0) == jc.wire_bytes(12345.0)
    for dt, jdt in ((torch.float32, np.dtype("float32")),
                    (torch.bfloat16, jnp.dtype(jnp.bfloat16)),
                    (np.float32, np.dtype("float32")), (None, None)):
        assert c.compressed_bytes(shape, dt) == jc.compressed_bytes(shape, jdt)
    assert c.error_bound == jc.error_bound
    assert c.encode_cost_s(1e6, 1e9) == jc.encode_cost_s(1e6, 1e9)
    assert c.decode_cost_s(1e6, 1e9) == jc.decode_cost_s(1e6, 1e9)


def test_identity_is_exact():
    x = torch.from_numpy(_x((3, 5), 1))
    assert get_codec("identity").transcode(x) is x


def _jax_or_np(x: np.ndarray, branch: str):
    """The JAX package's codecs take a jax array (served path) or numpy."""
    return jnp.asarray(x) if branch == "jax" else x


@pytest.mark.parametrize("branch", ["jax", "numpy"])
@pytest.mark.parametrize("shape", [(4, 256), (3, 7), (2, 5, 300)])
def test_fp16_matches_jax(shape, branch):
    """Round to nearest even in both; every 7th element scaled past 65504,
    where both clamp to the range edge and never produce inf."""
    x = _x(shape, 11 + len(shape)) * np.float32(3.0)
    x.reshape(-1)[::7] *= np.float32(1e5)
    y16, dtype = get_codec("fp16").encode(torch.from_numpy(x))
    jy16, jdtype = jax_get_codec("fp16").encode(_jax_or_np(x, branch))
    assert y16.dtype == torch.float16 and dtype == torch.float32
    np.testing.assert_array_equal(y16.numpy().view(np.uint16),
                                  np.asarray(jy16).view(np.uint16))
    y = get_codec("fp16").decode((y16, dtype))
    jy = np.asarray(jax_get_codec("fp16").decode((jy16, jdtype)))
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
    assert float(y.abs().max()) == get_codec("fp16").F16_MAX
    np.testing.assert_array_equal(y.numpy(), jy)


@pytest.mark.parametrize("branch", ["jax", "numpy"])
@pytest.mark.parametrize("shape", [(4, 256), (3, 7), (2, 5, 13), (999,), (1,)])
def test_topk_sparse_matches_jax(shape, branch):
    """The same index set (normal inputs: no ties) and the same decoded
    tensor; n = 21, 130 and 999 make ceil(n / 4) round up."""
    x = _x(shape, 21 + sum(shape))
    codec, jcodec = get_codec("topk-sparse"), jax_get_codec("topk-sparse")
    payload = codec.encode(torch.from_numpy(x))
    jpayload = jcodec.encode(_jax_or_np(x, branch))
    kind, shp, dtype, idx, vals = payload
    assert kind == "torch" and shp == shape and dtype == torch.float32
    assert idx.numel() == codec._k(x.size) == -(-x.size // 4)
    assert sorted(idx.tolist()) == sorted(np.asarray(jpayload[3]).tolist())
    y = codec.decode(payload)
    assert y.dtype == torch.float32 and tuple(y.shape) == shape
    np.testing.assert_array_equal(y.numpy(), np.asarray(jcodec.decode(jpayload)))


def test_configured_int8_refuses_another_device():
    codec = get_codec("int8").configured(device="cuda")
    with pytest.raises(ValueError, match="configured for cuda"):
        codec.encode(torch.ones(2, 256))
    assert get_codec("int8").device is None  # the registry singleton is untouched
    cpu = get_codec("int8").configured(device=torch.device("cpu"))
    assert cpu.encode(torch.ones(2, 256))[0] == "torch"


@pytest.mark.parametrize("name", ["fp16", "topk-sparse"])
def test_configured_codecs_refuse_another_device(name):
    codec = get_codec(name).configured(device="cuda")
    with pytest.raises(ValueError, match=f"{name} codec configured for cuda"):
        codec.encode(torch.ones(2, 256))
    assert get_codec(name).device is None  # the registry singleton is untouched
    x = torch.from_numpy(_x((2, 256), 4))
    cpu = get_codec(name).configured(device=torch.device("cpu"))
    assert torch.equal(cpu.transcode(x), get_codec(name).transcode(x))


def test_encoded_activation_decodes_through_its_codec():
    x = torch.from_numpy(_x((2, 256), 3))
    codec = get_codec("int8")
    enc = EncodedActivation(codec, codec.encode(x))
    assert torch.equal(enc.decode(), codec.transcode(x))


def test_link_assignment_matches_jax():
    from repro.dataplane import assign_link_codecs as jax_assign

    bw = np.full((5, 5), 1e5)
    kw = dict(codec="auto", tolerance=0.01, flops_per_node=[1e9] * 5, dispatcher=0)
    hops = [4096.0, 8192.0, 2048.0, 64.0, 512.0]
    assert assign_link_codecs(hops, [1, 2, 3, 4], bw, **kw) == \
        jax_assign(hops, [1, 2, 3, 4], bw, **kw)
