"""Per-device operation counts of a step, from the operations the program
issues.

The counterpart of ``repro/launch/hlo_analysis.py``. The reference reads
XLA's optimized, partitioned HLO: a per-device module whose dots, major
ops and collectives it walks with loop trip counts. The port has no HLO —
PyTorch runs eagerly — so :class:`OpCounter` is a ``TorchDispatchMode``
that counts the ATen operations each rank issues while the real step runs
(on the ``meta`` device under a fake process group, so nothing is
computed). For an operation on DTensors it returns ``NotImplemented``,
which lets DTensor run and lower it into the local operations and the
collectives of one rank; those it counts, so every number is per device:

* FLOPs: ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` (what ``matmul`` and
  ``einsum`` lower to), convolutions and SDPA, by
  ``torch.utils.flop_counter``'s formulas;
* bytes, under the reference's major-op traffic model: operand + output
  bytes of the operation classes of ``hlo_analysis._MAJOR_OPS`` (dots and
  convolutions, gathers and scatters, sorts, copies, reductions, pads,
  concatenations, cumulative sums, collectives); elementwise operations
  and casts are excluded, as XLA fuses them;
* collective bytes: each collective DTensor issues, from its result shape
  and group size, by ``roofline._ring_bytes``;
* the peak of live bytes: storages the run allocates (not its arguments),
  released when their last tensor dies.

The port's own kernels are counted by their closed form, not by the steps
of whichever implementation runs, so a count is the same work whether the
kernel or its plain version would run. The hooks are in
``kernels/opcount.py``, beside the kernels (a counter registers there on
entry): under a counter ``layers.grouped_attention`` calls
``opcount.attention_stand_ins`` (4·B·H·P·D operations forward for P kept
(query, key) pairs, 2.5× that backward; q, k, v and the output read or
written once), and the point-cloud entry points record theirs through
``opcount.kernel`` (PERF.md's kernel table: OS and dW 2·nnz·Cin·Cout, WS
2·kept_pairs·Cin·Cout, the segment sum and the searches by bytes).

Python loops over a sequence (Mamba's scan, sLSTM's recurrence, the
chunked mLSTM) count one trip times the trip count (``opcount.trips``,
the analogue of the while-trip multipliers of ``hlo_analysis.py``), so the
dry run does not walk 524,288 steps; ``OpCounter(trips=False)`` walks them.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels.opcount import ACTIVE
from .roofline import CollectiveOp, _DTYPE_BYTES, collective_op

# ATen operation classes that stream device memory (hlo_analysis._MAJOR_OPS)
_MAJOR = {
    "dot": ("mm", "bmm", "addmm", "baddbmm", "_scaled_dot_product_efficient_"
            "attention", "_scaled_dot_product_flash_attention",
            "_scaled_dot_product_cudnn_attention"),
    "convolution": ("convolution", "convolution_backward"),
    "gather": ("gather", "index", "index_select", "embedding",
               "embedding_dense_backward", "take_along_dim"),
    "scatter": ("scatter", "scatter_", "scatter_add", "scatter_add_",
                "index_put", "index_put_", "index_copy", "index_copy_",
                "index_add", "index_add_", "_index_put_impl_",
                "masked_scatter", "select_scatter", "slice_scatter"),
    "sort": ("sort", "topk", "argsort"),
    "copy": ("copy_", "clone", "_unsafe_view_copy"),
    "reduce": ("sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "norm", "linalg_vector_norm", "cummax",
               "cummin", "_softmax", "_log_softmax", "all", "any",
               "argmax", "argmin"),
    "pad": ("constant_pad_nd",),
    "concatenate": ("cat", "stack"),
    "reverse": ("flip",),
    "cumsum": ("cumsum",),
}
_CLASS = {name: cls for cls, names in _MAJOR.items() for name in names}

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}

def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return _DTYPE_BYTES.get(t.dtype, t.element_size()) * t.numel()


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, major-op bytes, collectives and the peak of live
    bytes of the operations issued inside it (module doc)."""

    def __init__(self, trips: bool = True):
        super().__init__()
        self.trips = trips
        self.flops = 0.0
        self.bytes = 0.0
        self.collective_bytes = 0.0
        self.by_collective: Dict[str, float] = {}
        self.collectives: List[CollectiveOp] = []
        self.flops_by_op: Dict[str, float] = {}
        self.bytes_by_class: Dict[str, float] = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._mult = 1.0
        self._paused = 0
        self._seen: Dict[int, int] = {}

    def __enter__(self):
        ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- what the model tells it -------------------------------------------

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Everything counted inside is counted ``n`` times."""
        self._mult, prev = self._mult * n, self._mult
        try:
            yield
        finally:
            self._mult = prev

    def add(self, name: str, flops: float, nbytes: float) -> None:
        """A closed form: ``flops`` and ``nbytes`` under ``name``."""
        self.flops += self._mult * flops
        self.bytes += self._mult * nbytes
        self.flops_by_op[name] = (self.flops_by_op.get(name, 0.0)
                                  + self._mult * flops)
        self.bytes_by_class[name] = (self.bytes_by_class.get(name, 0.0)
                                     + self._mult * nbytes)

    # -- dispatch ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # let DTensor lower it into local ops
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(t, FakeTensor) for t in _tensors(out)):
            return out              # DTensor's own shape propagation
        if not self._paused:
            self._count(func, args, kwargs, out)
        if not (func._schema.is_mutable or func.is_view):
            for t in _tensors(out):
                self._track(t)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        m = self._mult
        coll = (_COLLECTIVES.get(name) if func.namespace in (
            "_c10d_functional", "_dtensor") else None)
        if coll is not None:
            # (input, [reduce op], [group size], group name): the size is
            # an argument of the gathers and scatters, else the group's
            g = (args[1] if name.startswith("all_gather") else
                 args[2] if name.startswith("reduce_scatter") else
                 _group_size(args[-1]))
            for res in _tensors(out):
                op = collective_op(coll, res, int(g))
                self.collectives.append(op)
                self.collective_bytes += m * op.moved_bytes
                self.by_collective[coll] = (self.by_collective.get(coll, 0.0)
                                            + m * op.moved_bytes)
            cls = "collective"
        else:
            cls = _CLASS.get(name)
        from torch.utils.flop_counter import flop_registry
        fl = flop_registry.get(func._overloadpacket)
        if fl is not None:
            f = fl(*args, **kwargs, out_val=out)
            self.flops += m * f
            self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + m * f
        if cls is not None:
            nb = sum(_nbytes(t) for t in _tensors(args)) + sum(
                _nbytes(t) for t in _tensors(out))
            self.bytes += m * nb
            self.bytes_by_class[cls] = (self.bytes_by_class.get(cls, 0.0)
                                        + m * nb)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._seen.pop(key, 0)

    @contextlib.contextmanager
    def paused(self):
        """Nothing inside is counted (allocations still are)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1
