"""The port's checkpoints: bit-exact save/restore, the latest pointer and
GC, resume equal to an uninterrupted run, and the JAX package's on-disk
format in both directions, on the CPU.

A checkpoint the JAX package's ``Checkpointer`` writes is restored by the
port's to exactly ``params_from_numpy`` of the JAX state, and one the port
writes is restored by the JAX package's to exactly the port's state: the
leaves are ``jax.tree.flatten``'s order, bf16 as a uint16 view, in both.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch
from _lm_parity import leaves, to_numpy

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.models import lm as jlm
from repro.runtime import train as jtrain
from repro.runtime.checkpoint import Checkpointer as JaxCheckpointer
from repro_torch import configs as tconfigs
from repro_torch.models import lm as tlm
from repro_torch.models.common import params_from_numpy
from repro_torch.runtime import train as ttrain
from repro_torch.runtime.checkpoint import Checkpointer


@pytest.fixture()
def tiny_state():
    cfg = tconfigs.reduced(tconfigs.ARCHS["llama3.2-1b"])
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", max_pos=64)
    return cfg, ttrain.init_state(cfg, params)


def _assert_equal_trees(got, want):
    g, w = leaves(got), leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.device == b.device, path
        assert torch.equal(a, b), path


def test_save_restore_bit_exact(tmp_path, tiny_state):
    _, state = tiny_state
    ck = Checkpointer(tmp_path)
    ck.save(7, state)
    step, restored = ck.restore(state)
    assert step == 7
    _assert_equal_trees(restored, state)
    assert list(restored) == list(state)  # the template's key order
    meta = json.loads((tmp_path / "v000007" / "meta.json").read_text())
    assert meta["step"] == 7 and set(meta["dtypes"].values()) == {"uint16", "float32", "int32"}


def test_latest_pointer_and_gc(tmp_path, tiny_state):
    _, state = tiny_state
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, state)
    assert ck.latest_step() == 4
    dirs = sorted(d.name for d in ck.store.root.iterdir() if d.name.startswith("v"))
    assert dirs == ["v000003", "v000004"]  # older checkpoints GC'd
    with pytest.raises(Exception):
        ck.restore(state, step=1)  # collected


def test_restore_empty_raises(tmp_path, tiny_state):
    _, state = tiny_state
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path).restore(state)


def _clone(state):
    return {k: (v.clone() if isinstance(v, torch.Tensor) else
                {kk: _clone(vv) if isinstance(vv, dict) else vv.clone() for kk, vv in v.items()})
            for k, v in state.items()}


def test_resume_equals_uninterrupted(tmp_path, tiny_state):
    """Train 4 steps straight == train 2, checkpoint, restore, train 2 (the
    train step updates its state in place, so each run starts from a copy)."""
    cfg, state0 = tiny_state
    step_fn = ttrain.make_train_step(cfg, ttrain.OptConfig(lr=1e-3))
    batch = {"tokens": torch.arange(32, dtype=torch.int32).reshape(2, 16)}

    s = _clone(state0)
    for _ in range(4):
        s, _ = step_fn(s, batch)
    straight = s

    s = _clone(state0)
    for _ in range(2):
        s, _ = step_fn(s, batch)
    ck = Checkpointer(tmp_path)
    ck.save(2, s)
    _, s = ck.restore(_clone(state0))
    for _ in range(2):
        s, _ = step_fn(s, batch)
    _assert_equal_trees(s, straight)


def _jax_state():
    jcfg = jreduced(JARCHS["llama3.2-1b"])
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0), max_pos=64)
    state = jtrain.init_state(jcfg, params)
    step = jax.jit(jtrain.make_train_step(jcfg, jtrain.OptConfig(lr=1e-3)))
    state, _ = step(state, {"tokens": jax.numpy.arange(32, dtype=jax.numpy.int32).reshape(2, 16)})
    return state  # moments non-zero, step 1


def test_jax_checkpoint_restored_by_the_port(tmp_path):
    jstate = _jax_state()
    JaxCheckpointer(tmp_path).save(5, jstate)
    want = params_from_numpy(to_numpy(jstate), "cpu")
    like = jax.tree.map(torch.zeros_like, want)  # a template of the same tree
    step, got = Checkpointer(tmp_path).restore(like)
    assert step == 5
    _assert_equal_trees(got, want)


def test_port_checkpoint_restored_by_jax(tmp_path, tiny_state):
    cfg, state = tiny_state
    state, _ = ttrain.make_train_step(cfg, ttrain.OptConfig(lr=1e-3))(
        state, {"tokens": torch.arange(32, dtype=torch.int32).reshape(2, 16)})
    Checkpointer(tmp_path).save(3, state)
    like = _jax_state()
    step, got = JaxCheckpointer(tmp_path).restore(like)
    assert step == 3
    want = leaves(state)
    got = leaves(to_numpy(got))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, t) in zip(got, want):
        b = t.numpy() if t.dtype != torch.bfloat16 else t.view(torch.int16).numpy()
        a = np.asarray(a)
        a = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_same_files_as_jax(tmp_path):
    """The same state saved by both packages: equal meta JSON (step,
    structure, stored dtypes) and equal arrays under equal names."""
    jstate = _jax_state()
    JaxCheckpointer(tmp_path / "jax").save(2, jstate)
    Checkpointer(tmp_path / "port").save(2, params_from_numpy(to_numpy(jstate), "cpu"))
    meta = [json.loads((tmp_path / d / "v000002" / "meta.json").read_text()) for d in ("jax", "port")]
    assert meta[0] == meta[1]
    files = [np.load(tmp_path / d / "v000002" / "state.npz") for d in ("jax", "port")]
    assert sorted(files[0].files) == sorted(files[1].files)
    for k in files[0].files:
        a, b = files[0][k], files[1][k]
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k
