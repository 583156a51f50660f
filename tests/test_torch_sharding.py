"""The port's sharding policy (``repro_torch.sharding``) against the JAX
package's (``src/repro/sharding/policy.py``).

The rules read only axis names and sizes, so stub meshes exercise the exact
divisibility logic of the 256- and 512-chip production meshes: the JAX
stub has ``axis_names`` and ``devices``, the port's ``mesh_dim_names`` and
``shape``.  A spec is compared as ``tuple(PartitionSpec)``.  Every leaf of
every arch's param, train-state and decode-cache trees (the port's meta
stand-ins, ``launch/specs.py``) is held to the JAX rule on the same path
and shape, and the specs are turned into DTensor placements on a real
one-rank mesh and on fake ones.
"""

from __future__ import annotations

import numpy as np
import pytest
import jax
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import shape_cells
from repro.launch import specs as jax_specs
from repro.sharding import policy as jpol
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import specs as specs_lib
from repro_torch.sharding import policy as pol


class JaxStubMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape)


class StubMesh:
    def __init__(self, shape=(16, 16), axes=("data", "model")):
        self.mesh_dim_names = axes
        self.shape = shape


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
MESH = StubMesh()
MESH3 = StubMesh((2, 16, 16), ("pod", "data", "model"))


def _spec(cfg, path, shape, mesh=MESH):
    return pol._mk_rules(cfg, mesh).spec(cfg, path, shape)


# --- the JAX package's nine cases (tests/test_sharding_policy.py) ----------

def test_attention_heads_shard_when_divisible():
    cfg = ARCHS["llama3.2-1b"]  # 32 heads / 16 = 2
    assert _spec(cfg, "blocks/attn/wq", (16, 2048, 32, 64)) == (None, None, "model", None)


def test_qwen_padded_heads_shard():
    cfg = ARCHS["qwen2-7b"]  # 28 -> padded 32
    assert cfg.padded_heads == 32
    assert _spec(cfg, "blocks/attn/wq", (28, 3584, 32, 128)) == (None, None, "model", None)


def test_indivisible_heads_fall_to_head_dim():
    cfg = ARCHS["llama3.2-1b"]  # kv heads 8: not divisible by 16
    assert _spec(cfg, "blocks/attn/wk", (16, 2048, 8, 64)) == (None, None, None, "model")


def test_moe_experts_shard_over_model():
    cfg = ARCHS["kimi-k2-1t-a32b"]  # 384 experts, fsdp_full
    s = _spec(cfg, "blocks/mlp/w_gate", (61, 384, 7168, 2048))
    assert s[1] == "model" and s[2] == "data"  # E over model, d over data
    s3 = _spec(cfg, "blocks/mlp/w_gate", (61, 384, 7168, 2048), MESH3)
    assert s3[3] == "pod"  # f over pod on the multi-pod mesh


def test_embed_vocab_shards():
    assert _spec(ARCHS["gemma-2b"], "embed", (256000, 2048))[0] == "model"


def test_cache_split_kv_when_heads_indivisible():
    cfg = ARCHS["llama3.2-1b"]
    s = pol._cache_spec(cfg, MESH, "blocks/kv/k", (16, 128, 32768, 8, 64), ("data",))
    assert s == (None, "data", "model", None, None)  # seq over model


def test_cache_heads_shard_when_divisible():
    cfg = ARCHS["gemma2-27b"]  # 16 kv heads
    s = pol._cache_spec(cfg, MESH, "blocks/global/k", (23, 128, 32768, 16, 128), ("data",))
    assert s == (None, "data", None, "model", None)


def test_cache_batch_one_uses_data_axis_for_seq():
    cfg = ARCHS["gemma2-27b"]
    s = pol._cache_spec(cfg, MESH, "blocks/global/k", (23, 1, 524288, 16, 128), (None,))
    assert s == (None, None, "data", "model", None)


def test_single_device_mesh_replicates_everything():
    cfg = ARCHS["qwen2-7b"]
    s = _spec(cfg, "blocks/attn/wq", (28, 3584, 32, 128), StubMesh((1, 1)))
    assert all(ax in (None, "model", "data") for ax in s)


# --- every leaf of every arch, against the JAX rules -----------------------

def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _jax_param_spec(cfg, jmesh, path, shape):
    return tuple(jpol._mk_rules(cfg, jmesh).spec(cfg, path, tuple(shape)))


def _jax_cache_spec(cfg, jmesh, path, shape, batch):
    """``jpol.cache_shardings``' leaf rule (NamedSharding needs a real mesh)."""
    if path.split("/")[-1] == "pos" or len(shape) == 0:
        return ()
    bspec = jpol.batch_pspec(jmesh, batch)
    return tuple(jpol._cache_spec(cfg, jmesh, path, tuple(shape), bspec))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_leaf_spec_equals_the_jax_policy(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    mesh, jmesh = StubMesh(shape, axes), JaxStubMesh(shape, axes)
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    cells = shape_cells(jcfg)
    checked = 0
    # params of each max_pos (audio's follows the cell's sequence)
    for cell in {specs_lib.max_pos_for(cfg, SHAPES[c]): c for c in cells}.values():
        params = specs_lib.param_specs(cfg, SHAPES[cell])
        got = pol.param_shardings(cfg, mesh, params)
        for path, x in _leaves(params):
            assert pol._at(got, path) == _jax_param_spec(jcfg, jmesh, path, x.shape), (arch, path)
            checked += 1
    state = specs_lib.state_specs(cfg, SHAPES["train_4k"])
    got = pol.state_shardings(cfg, mesh, state)
    assert got["step"] == tuple(P())
    for part in ("params", "m", "v"):
        for path, x in _leaves(state[part]):
            want = _jax_param_spec(jcfg, jmesh, path, x.shape)
            assert pol._at(got[part], path) == want, (arch, part, path)
            checked += 1
    for cell in (c for c in cells if SHAPES[c].kind == "decode"):
        caches = specs_lib.cache_specs(cfg, SHAPES[cell])
        batch = SHAPES[cell].global_batch
        got = pol.cache_shardings(cfg, mesh, caches, batch)
        jtree = jax_specs.cache_specs(jcfg, JAX_SHAPES[cell])
        assert len(jax.tree_util.tree_leaves(jtree)) == len(list(_leaves(caches)))
        for path, x in _leaves(caches):
            shape_ = () if isinstance(x, int) else tuple(x.shape)
            want = _jax_cache_spec(jcfg, jmesh, path, shape_, batch)
            assert pol._at(got, path) == want, (arch, cell, path)
            checked += 1
        # without the batch, dim 1 of the first leaf is read, as in the JAX policy
        assert pol._first_batch_dim(caches) == jpol._first_batch_dim(jtree)
    assert checked > 20


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_pspec_equals_the_jax_policy(mesh_name):
    shape, axes = MESHES[mesh_name]
    for batch in (1, 32, 128, 256):
        assert pol.batch_pspec(StubMesh(shape, axes), batch) == tuple(
            jpol.batch_pspec(JaxStubMesh(shape, axes), batch)), batch
    assert pol.batch_axes(StubMesh(shape, axes)) == jpol.batch_axes(JaxStubMesh(shape, axes))


def test_activation_specs_equal_the_jax_policy():
    """``ShardingPolicy.act``'s specs are the JAX ``act``'s constraints."""
    cfg = ARCHS["llama3.2-1b"]
    policy = pol.ShardingPolicy(cfg, MESH3)
    q, kv = torch.empty(64, 8, 32, 64, device="meta"), torch.empty(64, 8, 8, 64, device="meta")
    assert policy.spec(q, "attn_q") == (("pod", "data"), None, "model", None)
    assert policy.spec(kv, "attn_kv") == (("pod", "data"), None, None, None)
    assert policy.spec(torch.empty(16, 8, 2048, device="meta"), "mlp_out") == ("pod", None, None)
    assert policy.spec(torch.empty(1, 8, 128256, device="meta"), "logits") == (None, None, "model")
    assert policy.spec(q, "something_else") is None
    plain = torch.ones(2, 3)
    assert policy.act(plain, "mlp_out") is plain  # a plain tensor passes unchanged


# --- specs to placements ----------------------------------------------------

def test_placements_shard_each_named_axis():
    from torch.distributed.tensor import Replicate, Shard

    assert pol.placements((None, "data", "model", None), MESH) == (Shard(1), Shard(2))
    assert pol.placements((None, None, None, "model"), MESH) == (Replicate(), Shard(3))
    assert pol.placements((), MESH) == (Replicate(), Replicate())
    assert pol.placements((("pod", "data"), None), MESH3) == (Shard(0), Shard(0), Replicate())
    # _cache_spec's split-KV over both axes of the pod mesh
    assert pol.placements((None, None, ("data", "model"), None, None), MESH) == (Shard(2),
                                                                                  Shard(2))
    assert pol.local_shape((23, 1, 524288, 16, 128), (None, None, ("data", "model"), None, None),
                           MESH) == (23, 1, 2048, 16, 128)


@pytest.mark.parametrize("spec, why", [
    ((("data", "pod"), None), "mesh's order"),
    ((("model", "data"), None), "mesh's order"),
    (("data", "data"), "twice"),
    (("expert", None), "not one of"),
])
def test_placements_refuse_what_dtensor_cannot_lay_out(spec, why):
    with pytest.raises(ValueError, match=why):
        pol.placements(spec, MESH3)


def test_local_shape_refuses_an_axis_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        pol.local_shape((8, 3), (None, "model"), MESH)


def test_place_on_a_one_rank_mesh_wraps_without_a_copy(one_rank_mesh):
    from torch.distributed.tensor import DTensor

    cfg = ARCHS["llama3.2-1b"]
    w = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    tree = {"blocks": {"attn": {"wq": w}}, "pos": 7}
    placed = pol.place(tree, {"blocks": {"attn": {"wq": (None, "data", "model")}}, "pos": ()},
                       one_rank_mesh)
    d = placed["blocks"]["attn"]["wq"]
    assert isinstance(d, DTensor) and placed["pos"] == 7
    assert d.to_local().data_ptr() == w.data_ptr()  # no copy
    assert torch.equal(pol.to_local(placed)["blocks"]["attn"]["wq"], w)
    # a one-card mesh's axes divide everything: heads over "model"
    assert pol.param_shardings(cfg, one_rank_mesh, tree)["blocks"]["attn"]["wq"] == (
        None, "model", None)


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A real one-rank gloo group and its (1, 1) mesh, torn down after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()
