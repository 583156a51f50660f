"""Sharding policies: TP / FSDP / EP over the production mesh, as DTensor
placements.

The JAX package's ``sharding/policy.py`` in PyTorch.  The rule table reads
only axis names and sizes, so it is plain Python here: a spec is a tuple
with one entry per tensor dim, each entry ``None`` (replicated), an axis
name, or a tuple of axis names (the dim sharded over several axes, the
first outermost) -- ``tuple(PartitionSpec)`` of the JAX package, entry for
entry.  Rules are path+shape based so they apply uniformly to the stacked
parameter trees (leading group axes are padded with ``None``).  Every rule
checks divisibility against the actual mesh axis size and falls back to
replication, so the same policy places on the (16, 16) pod mesh, the
(2, 16, 16) multi-pod mesh, and the one-card test mesh.

Axis convention:
  * "data"  -- batch / fsdp axis,
  * "model" -- tensor/expert-parallel axis,
  * "pod"   -- data-parallel across pods; also a storage axis for the
    1T MoE (fsdp_full shards expert d_ff over it).

A mesh is a ``DeviceMesh`` or anything with its ``mesh_dim_names`` and
``shape``.  ``placements`` turns a spec into DTensor placements, ``place``
puts a tree of tensors on a ``DeviceMesh`` by a spec tree, and
``ShardingPolicy`` is the model's activation hook: ``act`` redistributes a
DTensor activation (``with_sharding_constraint``'s counterpart) and
``scope`` runs a step under ``implicit_replication``, so the plain tensors
the model makes inside a step (rope tables, masks, recurrent states) join
DTensor ops as replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

# the LM kernels' custom ops, and their sharding rules with DTensor
import repro_torch.kernels.flash_attention.ops  # noqa: F401
import repro_torch.kernels.ssm_scan.ops  # noqa: F401
from repro_torch.kernels.library import register_dtensor_rules

register_dtensor_rules()

Spec = tuple  # one entry per tensor dim: None, an axis name, or a tuple of names


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis(mesh, name: str) -> int:
    return _axis_sizes(mesh).get(name, 1)


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _entry(axes: list[str]):
    """A spec entry naming ``axes``: None, one name, or a tuple of names (a
    ``PartitionSpec`` stores a one-name tuple as the name)."""
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def _batch_entry(mesh, axes: tuple[str, ...], batch: int):
    """The batch dim over as many of ``axes`` as divide it, in order."""
    taken = []
    div = 1
    for a in axes:
        n = _axis(mesh, a)
        if batch % (div * n) == 0:
            taken.append(a)
            div *= n
    return _entry(taken)


def batch_pspec(mesh, batch: int) -> Spec:
    """Shard the batch dim over as many batch axes as divide it."""
    return (_batch_entry(mesh, batch_axes(mesh), batch),)


def batch_shardings(mesh, batch: dict) -> dict:
    """Each batch leaf's spec: its first dim over the batch axes
    (``batch_pspec`` of the first leaf's), the others whole."""
    b = batch_pspec(mesh, next(iter(batch.values())).shape[0])[0]
    return {k: (b,) + (None,) * (len(_shape(x)) - 1) for k, x in batch.items()}


# ---------------------------------------------------------------------------
# Parameter shardings
# ---------------------------------------------------------------------------

def _div(n: int, mesh, axis: str | None):
    """axis if it divides n, else None (replicate)."""
    if axis is None or n % _axis(mesh, axis) != 0:
        return None
    return axis


@dataclasses.dataclass(frozen=True)
class _Rules:
    mesh: Any
    fsdp: str | None  # "data" or None
    pod: str | None  # "pod" for fsdp_full on the multi-pod mesh

    def spec(self, cfg, path: str, shape: tuple[int, ...]) -> Spec:
        """Trailing-dims spec, padded for leading stack dims."""
        name = path.split("/")[-1]
        base = self._base(cfg, path, name, shape)
        pad = len(shape) - len(base)
        if pad < 0:  # scalar-ish leaf matched a bigger rule; replicate
            return ()
        return tuple([None] * pad + list(base))

    # -- the rule table ----------------------------------------------------
    def _base(self, cfg, path: str, name: str, shape) -> list:
        m, f, pod = self.mesh, self.fsdp, self.pod
        moe = cfg.is_moe and "mlp" in path
        if name == "embed":
            return [_div(shape[-2], m, "model"), _div(shape[-1], m, f)]
        if name == "lm_head":
            return [_div(shape[-2], m, f), _div(shape[-1], m, "model")]
        if name == "patch_proj":
            return [None, _div(shape[-1], m, "model")]
        if name in ("pos", "dec_pos"):
            return [None, None]
        attn_proj = "attn/" in path or "cross/" in path or "shared_attn/" in path
        if name in ("wq", "wk", "wv") and attn_proj:
            d, h, hd = shape[-3], shape[-2], shape[-1]
            if _div(h, m, "model"):
                return [_div(d, m, f), "model", None]
            return [_div(d, m, f), None, _div(hd, m, "model")]
        if name == "wo":
            h, hd, d = shape[-3], shape[-2], shape[-1]
            if _div(h, m, "model"):
                return ["model", None, _div(d, m, f)]
            return [None, _div(hd, m, "model"), _div(d, m, f)]
        if name in ("bq", "bk", "bv"):
            h, hd = shape[-2], shape[-1]
            if _div(h, m, "model"):
                return ["model", None]
            return [None, _div(hd, m, "model")]
        if name == "router":
            return [None, None]
        if moe and name in ("w_gate", "w_up"):
            e, d, ff = shape[-3], shape[-2], shape[-1]
            return [_div(e, m, "model"), _div(d, m, f), _div(ff, m, pod)]
        if moe and name == "w_down":
            e, ff, d = shape[-3], shape[-2], shape[-1]
            return [_div(e, m, "model"), _div(ff, m, pod), _div(d, m, f)]
        if name in ("w_gate", "w_up"):  # dense gated MLP (d, ff)
            return [_div(shape[-2], m, f), _div(shape[-1], m, "model")]
        if name == "w_down":
            return [_div(shape[-2], m, "model"), _div(shape[-1], m, f)]
        if name == "in_proj":  # mamba (d, 2*d_in + 2N + H)
            return [_div(shape[-2], m, f), _div(shape[-1], m, "model")]
        if name == "conv_w":
            return [None, _div(shape[-1], m, "model")]
        if name == "conv_b":
            return [_div(shape[-1], m, "model")]
        if name == "norm_w":
            return [_div(shape[-1], m, "model")]
        if name == "out_proj":  # (d_in, d)
            return [_div(shape[-2], m, "model"), _div(shape[-1], m, f)]
        if name in ("wq", "wk", "wv", "w_ogate", "w_in"):  # mlstm/slstm (d, X)
            return [_div(shape[-2], m, f), _div(shape[-1], m, "model")]
        return [None] * min(len(shape), 1)  # norms, biases, gates: replicate


def _map_with_path(fn, tree: Any, path: tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over nested dicts, tuples and lists, the path
    joined by "/" as the JAX package's ``_path_str`` joins key paths."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _shape(x) -> tuple[int, ...]:
    return tuple(getattr(x, "shape", ()))


def _mk_rules(cfg, mesh) -> _Rules:
    fsdp = "data" if cfg.sharding in ("fsdp", "ep_fsdp", "fsdp_full") else None
    pod = "pod" if (cfg.sharding == "fsdp_full" and "pod" in mesh.mesh_dim_names) else None
    return _Rules(mesh=mesh, fsdp=fsdp, pod=pod)


def param_shardings(cfg, mesh, params: Any) -> Any:
    """Spec tree matching ``params`` (tensors, meta tensors, or anything
    with a ``shape``)."""
    rules = _mk_rules(cfg, mesh)
    return _map_with_path(lambda path, x: rules.spec(cfg, path, _shape(x)), params)


def state_shardings(cfg, mesh, state: Any) -> Any:
    """Train-state specs: m/v follow params; step replicated."""
    p = param_shardings(cfg, mesh, state["params"])
    return {"params": p, "m": p, "v": p, "step": ()}


# ---------------------------------------------------------------------------
# Cache shardings (decode)
# ---------------------------------------------------------------------------

def cache_shardings(cfg, mesh, caches: Any, batch: int | None = None) -> Any:
    """KV caches: batch over data axes, heads (or head_dim) over model."""
    baxes = batch_pspec(mesh, batch if batch is not None else (_first_batch_dim(caches) or 1))

    def leaf(path, x):
        name = path.split("/")[-1]
        if name == "pos" or len(_shape(x)) == 0:
            return ()
        return _cache_spec(cfg, mesh, path, _shape(x), baxes)

    return _map_with_path(leaf, caches)


def _first_batch_dim(caches) -> int:
    """Dim 1 of the first leaf of two dims or more, in ``jax.tree.leaves``'
    order (dict keys sorted): blocks/*/kv/k has shape (G, B, S, KH, hd)."""
    if isinstance(caches, dict):
        subtrees = [caches[k] for k in sorted(caches)]
    elif isinstance(caches, (tuple, list)):
        subtrees = list(caches)
    else:
        return _shape(caches)[1] if len(_shape(caches)) >= 2 else 0
    for t in subtrees:
        b = _first_batch_dim(t)
        if b:
            return b
    return 0 if subtrees else 1


def _cache_spec(cfg, mesh, path: str, shape, bspec: Spec) -> Spec:
    name = path.split("/")[-1]
    b = bspec[0] if len(bspec) else None
    if name in ("k", "v"):  # (G, B, S, KH, hd)
        pad = len(shape) - 4
        s, kh, hd = shape[-3], shape[-2], shape[-1]
        # B=1 (long-context decode) leaves the data axis idle: split-KV over it
        seq_ax = None if b is not None else _div(s, mesh, "data")
        if _div(kh, mesh, "model"):
            return (*([None] * pad), b, seq_ax, "model", None)
        if seq_ax and s % (_axis(mesh, "data") * _axis(mesh, "model")) == 0:
            return (*([None] * pad), b, ("data", "model"), None, None)
        if _div(s, mesh, "model"):
            # KV heads don't divide the model axis: shard the SEQUENCE dim
            # instead (FlashDecoding-style split-KV).  Head-dim sharding
            # partial-sums f32 logits every layer.
            return (*([None] * pad), b, "model", None, None)
        return (*([None] * pad), b, None, None, _div(hd, mesh, "model"))
    if name == "ssm":  # (G, per, B, H, dh, N)
        pad = len(shape) - 4
        return (*([None] * pad), b, _div(shape[-3], mesh, "model"), None, None)
    if name == "conv":  # (G, per, B, K-1, conv_dim)
        pad = len(shape) - 3
        return (*([None] * pad), b, None, _div(shape[-1], mesh, "model"))
    if name == "c":  # mlstm (G, per, B, H, dh+1, dh)
        pad = len(shape) - 4
        return (*([None] * pad), b, None, None, _div(shape[-1], mesh, "model"))
    if "slstm" in path:  # tuple state leaves (G, B, H, dh)
        pad = len(shape) - 3
        return (*([None] * pad), b, None, _div(shape[-1], mesh, "model"))
    return ()


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where the spec names that axis at tensor dim d, else
    ``Replicate()``.  An axis of size 1 gives ``Replicate()`` too: the same
    layout (the one rank holds the whole dim), and DTensor's view rules
    refuse some reshapes of a dim sharded over one rank.

    A tuple entry shards its dim over several mesh dims.  DTensor lays such
    a dim out over the mesh dims in mesh order (the first outermost), as
    the JAX package's tuple is laid out in its own order; a tuple in any
    other order than the mesh's raises (it is never reordered)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = _axis_sizes(mesh)
    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not one of the mesh's {names}")
            if a in where:
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            where[a] = d
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec} shards dim {d} over {axes}, not in the mesh's order "
                             f"{names}: DTensor would lay it out otherwise")
    return tuple(Shard(where[n]) if n in where and sizes[n] > 1 else Replicate()
                 for n in names)


def local_shape(shape: tuple[int, ...], spec: Spec, mesh) -> tuple[int, ...]:
    """One rank's shard of a tensor of ``shape`` placed by ``spec`` (every
    rule above shards only dims its axes divide)."""
    sizes = _axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if out[d] % sizes[a]:
                raise ValueError(f"dim {d} of {shape} does not divide over {a!r} ({sizes[a]})")
            out[d] //= sizes[a]
    return tuple(out)


def _place_leaf(t, spec: Spec, mesh):
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(t, torch.Tensor):  # the caches' Python-int position
        return t
    pl = placements(spec, mesh)
    if mesh.size() == 1:
        # a one-rank mesh: its one shard is the whole tensor, so wrap it in
        # place, no copy; on more ranks every leaf, replicated ones too,
        # takes rank 0's values
        return DTensor.from_local(t, mesh, pl, run_check=False)
    return distribute_tensor(t, mesh, pl)


def place(tree: Any, specs: Any, mesh) -> Any:
    """Each tensor of ``tree`` as a DTensor on ``mesh`` placed by the spec
    on the same path of ``specs`` (``param_shardings``' and the others'
    trees); non-tensor leaves stay as they are."""
    return _map_with_path(lambda path, t: _place_leaf(t, _at(specs, path), mesh), tree)


def _at(tree: Any, path: str) -> Any:
    for k in path.split("/") if path else ():
        tree = tree[int(k)] if isinstance(tree, (tuple, list)) else tree[k]
    return tree


def to_local(tree: Any) -> Any:
    """Each DTensor of ``tree`` gathered whole (``full_tensor``), each other
    leaf as it is."""
    from torch.distributed.tensor import DTensor

    return _map_with_path(lambda _, t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


# ---------------------------------------------------------------------------
# Activation policy hook
# ---------------------------------------------------------------------------

class ShardingPolicy:
    """Injected into the model; constrains key activations on the mesh."""

    dtensors = True  # the step's params, state, caches and batch are DTensors

    def __init__(self, cfg, mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.baxes = batch_axes(mesh)

    def _b(self, n: int):
        return _batch_entry(self.mesh, self.baxes, n)

    def spec(self, x, kind: str) -> Spec | None:
        """The spec ``act`` constrains an activation of this kind to, or
        None for a kind it leaves alone."""
        m = self.mesh
        if kind in ("attn_q", "attn_kv"):  # (B, S, H, hd)
            h = x.shape[2]
            if h % _axis(m, "model") == 0:
                return (self._b(x.shape[0]), None, "model", None)
            return (self._b(x.shape[0]), None, None, None)
        if kind in ("mlp_out", "final_hidden"):  # (B, S, d)
            return (self._b(x.shape[0]), None, None)
        if kind == "logits":  # (B, C, V)
            return (self._b(x.shape[0]), None, "model")
        return None

    def act(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """A DTensor redistributed to this kind's spec; a plain tensor, or a
        kind without a spec, unchanged."""
        from torch.distributed.tensor import DTensor

        spec = self.spec(x, kind)
        if spec is None or not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, placements(spec, self.mesh))

    def scope(self):
        """The context a step runs in: plain tensors made inside it join
        DTensor ops as replicated."""
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()
