"""Logical-axis sharding: one table from parameter/activation axis *names*
to mesh axes, resolved lazily against whatever mesh is active.

The port of ``repro/dist/sharding.py``. Models never mention mesh axes.
Parameters are created with logical axis names (``models/common.ParamCtx``
records them in the ``axes`` table ``init_params`` returns) and activations
pass through :func:`shard_act` with logical tuples; this module owns the
single name→mesh-axis table (:data:`DEFAULT_RULES`) and the policy
toggles:

* ``fsdp``       — whether ``d_model_fsdp`` parameter dims shard over the
                   data axis (ZeRO-3 style) or stay replicated (serving).
* ``seq_shard``  — long-context decode: the KV cache shards over *sequence*
                   on the model axis instead of KV heads.

Resolution is defensive so one table serves every mesh: axes not present in
the active mesh are dropped, a mesh axis is consumed at most once per spec
(first logical dim wins), and an axis that does not divide the concrete dim
is dropped rather than erroring — the constraint degrades to replication.

:func:`spec_for` returns the reference's ``PartitionSpec`` as a plain tuple
(one entry per dim up to the last sharded one: ``None``, a mesh axis name,
or a tuple of names), so it compares with the reference's directly.
:func:`placements_for` turns a spec into ``torch.distributed.tensor``
placements on a ``DeviceMesh`` (``Shard(d)`` on each named mesh dim,
``Replicate()`` elsewhere); :func:`distribute_params` places a parameter
tree; inside the context :func:`shard_act` redistributes a ``DTensor``
activation (the counterpart of ``with_sharding_constraint``).

Everything is a no-op outside :func:`sharding_ctx` — :func:`shard_act`
returns its argument itself — so single-device runs execute exactly the
code they ran before. The reference's ``jax_threefry_partitionable``
switch has no counterpart: the port draws its init on one generator, the
same on every rank, then distributes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

# logical axis name -> preferred mesh axes (in priority order; a *prefix*
# whose size product divides the dim is kept, the rest dropped).
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),                    # full-sequence activations stay whole
    "seq_sp": ("model",),         # Megatron-SP residual stream between blocks
    "kv_seq": ("model",),         # only when seq_shard=True (split-K decode)
    "expert_cap": (),             # capacity-shard experiment flips this
    # parameters
    "vocab": ("model",),
    "d_model": (),                # norms / router: replicated
    "d_model_fsdp": ("data",),    # only when fsdp=True
    "heads": ("model",),
    "kv_heads": ("model",),       # only when seq_shard=False
    "d_ff": ("model",),
    "conv": (),
    "experts": ("model",),        # EP: expert dim over the model axis
    "expert_ff": (),              # EP already covers the FF dim
    "layers": (),                 # the stacked-layers dim
}

Spec = Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Mesh axis names and sizes with no devices behind them (the
    counterpart of ``jax.sharding.AbstractMesh``): enough to resolve specs
    for a mesh this process cannot build."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an :class:`AbstractMesh`,
    in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


@dataclasses.dataclass
class _Ctx:
    mesh: object
    rules: Dict[str, Tuple[str, ...]]
    fsdp: bool
    seq_shard: bool


_STACK: list = []


def _current() -> Optional[_Ctx]:
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def sharding_ctx(mesh, *, rules: Optional[Dict[str, Tuple[str, ...]]] = None,
                 fsdp: bool = True, seq_shard: bool = False):
    """Activate a mesh (a ``DeviceMesh`` with named dims, or an
    :class:`AbstractMesh`) and a rule table for :func:`spec_for`,
    :func:`shard_act` and :func:`param_shardings`. Inside it a plain tensor
    meeting a DTensor in an operation counts as replicated (positions,
    masks, constants: the same on every rank)."""
    from torch.distributed.tensor.experimental import implicit_replication
    ctx = _Ctx(mesh=mesh,
               rules=dict(DEFAULT_RULES if rules is None else rules),
               fsdp=fsdp, seq_shard=seq_shard)
    _STACK.append(ctx)
    try:
        with implicit_replication():
            yield ctx
    finally:
        _STACK.pop()


def seq_shard_active() -> bool:
    ctx = _current()
    return bool(ctx and ctx.seq_shard)


def _candidates(name: Optional[str], rules, fsdp: bool, seq_shard: bool
                ) -> Tuple[str, ...]:
    if name is None:
        return ()
    if name == "d_model_fsdp" and not fsdp:
        return ()
    if name == "kv_seq" and not seq_shard:
        return ()
    if name == "kv_heads" and seq_shard:
        return ()  # the model axis belongs to kv_seq in split-K decode
    return tuple(rules.get(name, ()))


def resolve_spec(logical: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]], sizes: Dict[str, int],
                 rules: Dict[str, Tuple[str, ...]] = DEFAULT_RULES, *,
                 fsdp: bool = True, seq_shard: bool = False) -> Spec:
    """The resolution of :func:`spec_for` as a pure function of the logical
    axes, the shape, the mesh's ``{axis: size}`` and the policy."""
    used: set = set()
    parts: list = []
    for d, name in enumerate(logical):
        cand = [a for a in _candidates(name, rules, fsdp, seq_shard)
                if a in sizes and a not in used]
        if shape is not None:
            # keep the longest prefix whose size product divides the dim
            while cand and shape[d] % math.prod(sizes[a] for a in cand):
                cand.pop()
        used.update(cand)
        if not cand:
            parts.append(None)
        elif len(cand) == 1:
            parts.append(cand[0])
        else:
            parts.append(tuple(cand))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_for(logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Spec:
    """Resolve a logical axis tuple to a spec under the active context
    (``()`` outside it). With ``shape`` given, mesh axes that do not
    evenly divide the dim are dropped (replicate rather than fail). Each
    mesh axis is used at most once; earlier logical dims win."""
    ctx = _current()
    if ctx is None:
        return ()
    return resolve_spec(logical, shape, mesh_axes(ctx.mesh), ctx.rules,
                        fsdp=ctx.fsdp, seq_shard=ctx.seq_shard)


def placements_for(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that the spec names for tensor dim ``d``, ``Replicate()`` on the
    others. A tensor dim over several mesh dims (``("pod", "data")``) is
    split in mesh order, as the reference's spec lists them."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh_axes(mesh))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_act(x, logical: Sequence[Optional[str]]):
    """Constrain an activation's sharding: inside :func:`sharding_ctx` a
    ``DTensor`` is redistributed to the spec's placements (a plain tensor
    passes through); outside it returns ``x`` itself."""
    ctx = _current()
    if ctx is None or not is_dtensor(x):
        return x
    spec = spec_for(logical, x.shape)
    if spec == ():
        return x
    placements = placements_for(spec, x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def local_linear(fn, x, w, k: int = 1):
    """``fn(x, w)`` — a product contracting x's last ``k`` dims with w's
    first ``k``, the result ``x.shape[:-k] + w.shape[k:]`` — on plain
    tensors as it is; on DTensors per rank through ``local_map``, so that
    each rank runs ``fn`` itself on its shards (bitwise the plain product
    at world size 1). Per mesh dim: where x's contracted dim is split, w's
    matching dim is split alike and the result is a partial sum
    (row-parallel); where x's leading (batch) dim is split, w is gathered
    there (FSDP's all-gather) and the result split alike; where w's output
    dims are split, x is gathered (a sequence split: Megatron-SP's
    all-gather) and the result split on that dim (column-parallel); where
    only x's sequence is split, w is gathered; elsewhere both are
    whole."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return fn(x, w)
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from torch.distributed.tensor.experimental import local_map
    mesh = (w if is_dtensor(w) else x).device_mesh
    rep = (Replicate(),) * mesh.ndim
    x, w = (t if is_dtensor(t) else DTensor.from_local(t, mesh, rep)
            for t in (x, w))
    nb = x.ndim - k
    xp, wp, op = [], [], []
    for a, b in zip(x.placements, w.placements):
        if a.is_partial():
            a = Replicate()
        if a.is_shard() and a.dim >= nb:            # row-parallel
            xp.append(a), wp.append(Shard(a.dim - nb)), op.append(Partial())
        elif a.is_shard() and a.dim == 0:           # batch split: gather w
            xp.append(a), wp.append(Replicate()), op.append(a)
        elif b.is_shard() and b.dim >= k:           # column-parallel
            xp.append(Replicate()), wp.append(b)
            op.append(Shard(nb + b.dim - k))
        elif a.is_shard():                          # sequence split
            xp.append(a), wp.append(Replicate()), op.append(a)
        else:
            xp.append(Replicate()), wp.append(Replicate())
            op.append(Replicate())
    # the gradients each rank computes: x's is a partial sum where w's
    # output dims are split (column-parallel), w's where x's leading dims
    # are split (batch, sequence)
    xg = tuple(Partial() if b.is_shard() and b.dim >= k else a
               for a, b in zip(xp, wp))
    wg = tuple(Partial() if a.is_shard() and a.dim < nb else b
               for a, b in zip(xp, wp))
    x = x.redistribute(mesh, tuple(xp))
    w = w.redistribute(mesh, tuple(wp))
    return local_map(fn, out_placements=(tuple(op),),
                     in_placements=(tuple(xp), tuple(wp)),
                     in_grad_placements=(xg, wg), device_mesh=mesh)(x, w)


def local_batch(fn, batched: Sequence, rest: Sequence = (), n_out: int = 1):
    """``fn(*batched, *rest)`` on plain tensors; on DTensors through
    ``local_map`` per rank on its batch shard: each ``batched`` tensor (and
    each of the ``n_out`` outputs) split on dim 0 as the batch is
    (``batch_spec``), each ``rest`` tensor (parameters) whole on every
    rank. For recurrences over a sequence (the Mamba scan, the mLSTM
    chunks, the sLSTM steps), which are independent per sequence and
    whose inner operations DTensor cannot partition: any other split of
    their inputs is gathered first (replication forced over the model
    axis)."""
    tensors = [t for t in (*batched, *rest) if isinstance(t, torch.Tensor)]
    if not any(is_dtensor(t) for t in tensors):
        return fn(*batched, *rest)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t for t in tensors if is_dtensor(t)).device_mesh
    rep = (Replicate(),) * mesh.ndim
    bp = placements_for(batch_spec(mesh, batched[0].shape[0]), mesh)

    def place(t, pl):
        if not isinstance(t, torch.Tensor):
            return t
        t = t if is_dtensor(t) else DTensor.from_local(t, mesh, rep)
        return t.redistribute(mesh, pl)
    args = ([place(t, bp) for t in batched]
            + [place(t, rep) for t in rest])
    places = tuple((bp if i < len(batched) else rep)
                   if isinstance(a, torch.Tensor) else None
                   for i, a in enumerate(args))
    # a whole tensor's gradient is a partial sum over the batch's shards
    part = tuple(Partial() if p.is_shard() else Replicate() for p in bp)
    grads = tuple(None if p is None else p if i < len(batched) else part
                  for i, p in enumerate(places))
    return local_map(fn, out_placements=(bp,) * n_out, in_placements=places,
                     in_grad_placements=grads, device_mesh=mesh)(*args)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's sharding: its mesh and spec (``jax.sharding.NamedSharding``'s
    counterpart), with the DTensor placements that realise it."""

    mesh: object
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


def _map_tree(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_shardings(axes: Dict[str, Tuple[Optional[str], ...]], params):
    """:class:`NamedSharding` for every leaf of a parameter (or
    optimizer-moment) tree, a nested dict of tensors or shapes.

    ``axes`` maps slash-joined tree paths to logical axis tuples — exactly
    what ``init_params`` / ``abstract_params`` record. Every leaf must have
    an entry whose rank matches (stacked leaves carry a leading "layers"
    axis), so a drifted scope name fails loudly rather than silently
    replicating a tensor."""
    ctx = _current()
    if ctx is None:
        raise RuntimeError("param_shardings requires an active sharding_ctx")

    def one(key, leaf):
        if key not in axes:
            raise KeyError(f"no logical axes recorded for param {key!r}")
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
        logical = axes[key]
        if len(logical) != len(shape):
            raise ValueError(f"{key}: axes {logical} for shape {shape}")
        return NamedSharding(ctx.mesh, spec_for(logical, shape))
    return _map_tree(one, params)


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """``t`` (the whole tensor, the same on every rank) as a DTensor with
    ``sharding``: each rank keeps its own shard, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def distribute_params(params, axes, mesh=None):
    """The tree ``params`` (whole tensors, the same on every rank) as
    DTensors on the active context's mesh, each placed by its logical axes
    (:func:`param_shardings`)."""
    ctx = _current()
    if ctx is None or (mesh is not None and mesh is not ctx.mesh):
        raise RuntimeError("distribute_params needs the sharding_ctx of "
                           "its mesh")
    shardings = param_shardings(axes, params)
    return _map_tree(lambda key, t: distribute(t, _leaf(shardings, key)),
                     params)


def _leaf(tree, key: str):
    for k in key.split("/"):
        tree = tree[k]
    return tree


def batch_spec(mesh, global_batch: int) -> Spec:
    """The batch's spec (the reference's ``launch/specs._batch_spec``): its
    first dim over ``("pod", "data")`` when their product divides it, else
    over ``"pod"`` when that divides it, else replicated."""
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    if global_batch % math.prod(sizes[a] for a in axes) == 0:
        return (axes,) if len(axes) > 1 else axes
    if "pod" in sizes and global_batch % sizes["pod"] == 0:
        return ("pod",)
    return ()


def shard_batch(batch: dict, mesh, device) -> dict:
    """Every array of ``batch`` (the same whole batch on every rank) as a
    DTensor on ``mesh`` placed by :func:`batch_spec`, on ``device``."""
    out = {}
    for k, v in batch.items():
        if v is None or is_dtensor(v):
            out[k] = v
            continue
        t = torch.as_tensor(v, device=device)
        out[k] = distribute(t, NamedSharding(mesh, batch_spec(mesh,
                                                              t.shape[0])))
    return out


def whole(t):
    """A DTensor as its whole tensor on this rank (gathered: every rank
    must call it); anything else as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def to_local_tree(tree):
    """Every DTensor leaf of a nested dict as its whole tensor (gathered),
    other leaves as they are."""
    return _map_tree(lambda _, t: whole(t), tree)
