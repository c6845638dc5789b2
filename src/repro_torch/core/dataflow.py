"""Feature-computation dataflows (Spira §5.4) and their backward passes —
torch port of ``repro.core.dataflow``.

Output-stationary (OS): per offset, gather the input rows through the
kernel map and multiply by that offset's weights, accumulating in fp32;
no filtering and no merge. Weight-stationary (WS): per offset, compact the
valid pairs to a static ``capacity`` (the first ``capacity`` valid rows of
a column survive, the rest are dropped), multiply the gathered rows by the
offset's weights and merge the products into their output rows, offset
after offset. Hybrid: offsets with L1 norm below ``t`` through OS, the
rest through WS, summed as ``(0 + os_half) + ws_half``.

Every dataflow takes ``backend`` ∈ {"auto", "torch", "cuda"}
(``kernels.ops.resolve_backend``): on the card the OS implicit-GEMM kernel
(``kernels.spconv_gather_gemm``) and the WS scatter-GEMM kernel
(``kernels.ws_scatter_gemm``), on CPU tensors their plain versions
(:func:`os_torch`, :func:`ws_torch`).

Numerics: fp32 accumulation over the same operands in the same offset
order on both backends; the CUDA kernels' per-element add order within one
product differs from a library matmul's, so the two agree within fp32
rounding, not bit for bit.

Backward passes (the reference's custom VJPs, here
``torch.autograd.Function``s) rest on the kernel-map transposition
identity ``M[i,k] = j ⇒ Mᵀ[j, mirror(k)] = i`` and need no new kernel-map
search:

* **dF** is the same dataflow — on the card the same kernel — over the
  transposed map (``kernel_map.transpose_kernel_map``; for a submanifold
  layer, ``self_transpose``, the forward map itself) with the weights
  mirrored along the offset axis and transposed to ``[Kd, Cout, Cin]``;
* **dW** is the per-offset gathered-feature contraction with the
  cotangent (``kernels.ops.spconv_dw_fused``), its row axis reduced in
  fixed panels so weight gradients are bitwise equal across capacity
  buckets;
* WS differentiates the function it computed: pairs beyond ``capacity``
  leave the map (:func:`ws_kept_map`) before it is transposed.

A dF that no input needs (the stem's features) is not computed.
Precondition, as in the reference: a differentiated column subset must be
mirror-closed and offset-ordered (the full map or an ``l1_partition``
subset), so position reversal is the true δ → −δ mirror.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels import opcount
# the fixed-panel row contraction lives beside the dW kernel as its plain
# version; re-exported here, where the reference defines it
from ..kernels.dw_gather_gemm import chunked_rowdot  # noqa: F401
from .kernel_map import KernelMap, l1_partition, transpose_kernel_map
from .packing import device_constant


def _mask_rows(x: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Zero rows at and beyond ``count``."""
    keep = torch.arange(x.shape[0], device=x.device) < count
    return torch.where(keep[:, None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))


def rowsum(x: torch.Tensor) -> torch.Tensor:
    """Column sums as a ``[1, N] @ [N, C]`` fp32 matmul, in ``x``'s dtype:
    the reference's whole-buffer reduction idiom (a dot, whose grouping of
    a shared row prefix does not change when zero rows are appended).
    Only the retired sliced BN baseline
    (``models.pointcloud._relu_bn_sliced``) uses it; the serving and
    training paths reduce per scene on the segment engine."""
    ones = torch.ones((1, x.shape[0]), dtype=torch.float32, device=x.device)
    return (ones @ x.float())[0].to(x.dtype)


def bcast_rows(v: torch.Tensor, cap: int) -> torch.Tensor:
    """Broadcast a [C] vector over ``cap`` rows as the rank-1 matmul
    ``ones[cap, 1] @ v[None, :]`` (forward-exact; autograd's row
    reduction of its cotangent is then a matmul, as in :func:`rowsum`)."""
    return torch.ones((cap, 1), dtype=v.dtype, device=v.device) @ v[None, :]


# ---------------------------------------------------------------------------
# dense per-row layer (the classifier head)
# ---------------------------------------------------------------------------

HEAD_ROWS = 8192   # fixed row-chunk shape of the classifier head


def head_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over fixed ``[HEAD_ROWS, C]`` row chunks (the last one
    zero-padded), so every call multiplies the same shape: a library GEMM
    may pick another algorithm, and another add order, at another row
    count, and the batched-equals-single contract must not depend on the
    capacity bucket."""
    n, c = x.shape
    chunks = -(-n // HEAD_ROWS)
    xp = x.new_zeros((chunks * HEAD_ROWS, c))
    xp[:n] = x
    out = torch.cat([torch.matmul(xp[i * HEAD_ROWS:(i + 1) * HEAD_ROWS], w)
                     for i in range(chunks)])
    return out[:n]


class _RowdotMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, backend):
        ctx.save_for_backward(x, w)
        ctx.backend = backend
        return head_matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = head_matmul(g, w.t()).to(x.dtype) if ctx.needs_input_grad[0] \
            else None
        dw = None
        if ctx.needs_input_grad[1]:
            # the identity map: row r reads input row r, one "offset"
            rows = torch.arange(x.shape[0], dtype=torch.int32,
                                device=x.device)[:, None]
            dw = kops.spconv_dw_fused(x, rows, g.to(x.dtype),
                                      backend=ctx.backend)[0].to(w.dtype)
        return dx, dw, None


def rowdot_matmul(x: torch.Tensor, w: torch.Tensor, *,
                  backend: str = "auto") -> torch.Tensor:
    """``x @ w`` for a dense layer applied per voxel row (the classifier
    head): forward and dx over :func:`head_matmul`'s fixed row chunks; dW
    reduces over the capacity-sized row axis in the fixed panels of
    ``kernels.dw_gather_gemm`` (the identity map), so it is bitwise equal
    across capacity buckets."""
    return _RowdotMatmul.apply(x, w, backend)


# ---------------------------------------------------------------------------
# forward dataflows (plain versions and kernel dispatch)
# ---------------------------------------------------------------------------

def os_torch(features: torch.Tensor, m: torch.Tensor, weights: torch.Tensor,
             *, fuse: bool = False) -> torch.Tensor:
    """OS dataflow in plain torch. ``fuse=True`` materializes one
    [M, Kd, Cin] gather and contracts it in one einsum; the default loops
    over offsets with an [M, Cin] working set (the plain version of the
    CUDA kernel)."""
    if not fuse:
        from ..kernels.spconv_gather_gemm import spconv_gather_gemm_torch
        return spconv_gather_gemm_torch(features, m, weights)
    g = features[m.clamp(min=0).long()] * (m >= 0)[..., None].to(
        features.dtype)
    return torch.einsum("mkc,kcd->md", g.float(),
                        weights.float()).to(features.dtype)


def _os_primal(features, m, weights, fuse, backend, bm, bn):
    # counted by the kernel's closed form whichever runs (kernels.opcount)
    with opcount.kernel("spconv_gather_gemm",
                        *kops.gemm_counts(features, m, weights)):
        if kops.resolve_backend(backend, features):
            return kops.spconv_os_fused(features, m, weights, backend="cuda",
                                        bm=bm, bn=bn)
        return os_torch(features, m, weights, fuse=fuse)


def ws_torch(features: torch.Tensor, m: torch.Tensor, weights: torch.Tensor,
             *, capacity: int, cols=None) -> torch.Tensor:
    """WS dataflow in plain torch (``ws_xla``): per-column compaction to
    ``capacity``, gather, fp32 GEMM and a merge into the output rows in
    column order; the result in the features' dtype. ``cols``: the map
    columns the offsets read (None: all)."""
    from ..kernels.ws_scatter_gemm import ws_scatter_gemm_torch
    return ws_scatter_gemm_torch(features, m, weights, capacity=capacity,
                                 cols=cols).to(features.dtype)


def _ws_primal(features, m, weights, capacity, backend, bm, bn, cols=None):
    with opcount.kernel("ws_scatter_gemm", *kops.gemm_counts(
            features, m, weights, capacity, cols=cols)):
        if kops.resolve_backend(backend, features):
            return kops.spconv_ws_fused(features, m, weights,
                                        capacity=capacity, backend="cuda",
                                        bm=bm, bn=bn, cols=cols)
        return ws_torch(features, m, weights, capacity=capacity, cols=cols)


def ws_kept_map(m: torch.Tensor, capacity: int) -> torch.Tensor:
    """The kernel map WS actually computes with: valid pairs beyond
    ``capacity`` in their column (row order) replaced by −1."""
    valid = m >= 0
    # the column scan runs over contiguous rows of the transpose (fast on
    # the card, unlike a scan over the outer dimension)
    rank = torch.cumsum(valid.t().contiguous(), dim=1).t()
    keep = valid & (rank <= capacity)
    return torch.where(keep, m, torch.full((), -1, dtype=m.dtype,
                                           device=m.device))


# ---------------------------------------------------------------------------
# backward machinery
# ---------------------------------------------------------------------------

def _grad_weights(weights: torch.Tensor) -> torch.Tensor:
    """Weights as the backward dataflow wants them: mirrored along the
    offset axis (column k of the transposed map is offset −δ_{mirror(k)})
    and transposed in (Cin, Cout) — ``[Kd, Cout, Cin]``."""
    return weights.transpose(1, 2).flip(0).contiguous()


def _dw_per_offset(features: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                   out_dtype, backend: str) -> torch.Tensor:
    """``dW[k] = G_kᵀ @ g`` with ``G_k`` the offset's gathered, masked
    features; fp32 accumulation over fixed row panels
    (``kernels.ops.spconv_dw_fused``), never an ``[M, Kd, Cin]`` tensor."""
    return kops.spconv_dw_fused(features, m, g.to(features.dtype),
                                backend=backend).to(out_dtype)


class _OutputStationary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, m, weights, fuse, backend, bm, bn, self_t):
        ctx.save_for_backward(features, m, weights)
        ctx.cfg = (fuse, backend, self_t)
        return _os_primal(features, m, weights, fuse, backend, bm, bn)

    @staticmethod
    def backward(ctx, g):
        features, m, weights = ctx.saved_tensors
        fuse, backend, self_t = ctx.cfg
        g = g.to(features.dtype)
        df = dw = None
        if ctx.needs_input_grad[0]:
            # the OS dataflow itself over the transposed map: on the card
            # the same implicit-GEMM kernel, reading g instead of F
            mt = m if self_t else transpose_kernel_map(
                m, n_in=features.shape[0])
            df = _os_primal(g, mt, _grad_weights(weights), fuse, backend,
                            0, 0)
        if ctx.needs_input_grad[2]:
            dw = _dw_per_offset(features, m, g, weights.dtype, backend)
        return df, None, dw, None, None, None, None, None


def output_stationary(features: torch.Tensor, m: torch.Tensor,
                      weights: torch.Tensor, *, fuse: bool = False,
                      backend: str = "auto", bm: int = 0, bn: int = 0,
                      self_transpose: bool = False) -> torch.Tensor:
    """OS dataflow: ``features`` [N, Cin], ``m`` int32 [M, Kd] (a kernel-map
    column subset), ``weights`` [Kd, Cin, Cout] → [M, Cout]. On the kernel
    path the gather is fused in and ``fuse`` is moot. Differentiable in
    ``features`` and ``weights`` (module doc); ``self_transpose``: the
    caller asserts the map is its own transpose (a submanifold layer), so
    the backward skips the mirror scatter — bitwise the same gradients."""
    return _OutputStationary.apply(features, m, weights, fuse, backend, bm,
                                   bn, self_transpose)


class _WeightStationary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, m, weights, capacity, backend, bm, bn,
                self_t, cols):
        ctx.save_for_backward(features, m, weights)
        ctx.cfg = (capacity, backend, self_t, cols)
        return _ws_primal(features, m, weights, capacity, backend, bm, bn,
                          cols)

    @staticmethod
    def backward(ctx, g):
        features, m, weights = ctx.saved_tensors
        capacity, backend, self_t, cols = ctx.cfg
        if cols is not None:
            m = m[:, cols.long()]
        g = g.to(features.dtype)
        # differentiate the function WS computed: drop the overflow pairs
        # first, then transpose
        mk = ws_kept_map(m, capacity)
        df = dw = None
        if ctx.needs_input_grad[0]:
            # a dropped map is not its own transpose even on a submanifold
            # layer (the drop keeps forward column order): skip the mirror
            # scatter only at a statically lossless capacity
            if self_t and capacity >= m.shape[0]:
                mt = mk
            else:
                mt = transpose_kernel_map(mk, n_in=features.shape[0])
            # every transposed column holds <= capacity pairs (it mirrors a
            # kept column) and <= min(M, N) (columns are injective): this
            # capacity is lossless and keeps the backward's tables small
            bw_cap = min(capacity, m.shape[0], features.shape[0])
            df = _ws_primal(g, mt, _grad_weights(weights), bw_cap, backend,
                            0, 0)
        if ctx.needs_input_grad[2]:
            dw = _dw_per_offset(features, mk, g, weights.dtype, backend)
        return df, None, dw, None, None, None, None, None, None


def weight_stationary(features: torch.Tensor, m: torch.Tensor,
                      weights: torch.Tensor, *, capacity: int,
                      backend: str = "auto", bm: int = 0, bn: int = 0,
                      self_transpose: bool = False,
                      cols: torch.Tensor | None = None) -> torch.Tensor:
    """WS dataflow: ``features`` [N, Cin], ``m`` int32 [M, Ks], ``weights``
    [Ks, Cin, Cout] → [M, Cout] in the features' dtype. Valid pairs beyond
    ``capacity`` per column are dropped; ``capacity = M`` is lossless.
    ``cols`` (an int tensor of Ks column indices): offset k reads column
    ``cols[k]`` of a wider ``m`` in place (the kernel path copies no column
    subset; the backward takes the subset). Differentiable in ``features``
    and ``weights``; the gradients are those of the dropped function
    (module doc). ``self_transpose`` as in :func:`output_stationary`,
    effective only at a lossless capacity."""
    return _WeightStationary.apply(features, m, weights, capacity, backend,
                                   bm, bn, self_transpose, cols)


def ws_overflow(kmap: KernelMap, cols: np.ndarray,
                capacity: int) -> torch.Tensor:
    """Diagnostic: True if any selected column exceeds the WS capacity."""
    idx = torch.as_tensor(cols, dtype=torch.long, device=kmap.m.device)
    return (kmap.column_counts()[idx] > capacity).any()


def _take(x: torch.Tensor, idx: np.ndarray, dim: int) -> torch.Tensor:
    """``x`` indexed by ``idx`` along ``dim``; ``x`` itself (no copy) when
    ``idx`` is every index in order. On weights, autograd takes the
    gradient back with ``index_add`` into zeros: the indices are distinct,
    so every element receives one add and the result is exact."""
    if idx.size == x.shape[dim] and (idx == np.arange(idx.size)).all():
        return x
    return x.index_select(dim, device_constant(idx, torch.long, x.device))


def hybrid(features: torch.Tensor, kmap: KernelMap, weights: torch.Tensor,
           *, K: int, stride: int, t: int, ws_capacity: int,
           fuse_dense: bool = False, backend: str = "auto", bm: int = 0,
           bn: int = 0, self_transpose: bool = False) -> torch.Tensor:
    """Hybrid dataflow: offsets with L1 < t through OS (the dense half),
    the rest through WS (the sparse half), added to a zero accumulator in
    that order. ``t = 0`` is full WS, ``t = L1NormMax + 1`` full OS.
    Differentiable through both halves; ``self_transpose`` applies to both
    (the ``l1_partition`` subsets of a submanifold map are mirror-closed)."""
    dense_idx, sparse_idx = l1_partition(K, stride, t)
    out = torch.zeros((kmap.m.shape[0], weights.shape[-1]),
                      dtype=features.dtype, device=features.device)
    if dense_idx.size:
        out = out + output_stationary(
            features, _take(kmap.m, dense_idx, 1),
            _take(weights, dense_idx, 0), fuse=fuse_dense, backend=backend,
            bm=bm, bn=bn, self_transpose=self_transpose)
    if sparse_idx.size:
        # the WS half reads its columns of the map in place
        every = (sparse_idx.size == kmap.m.shape[1]
                 and (sparse_idx == np.arange(sparse_idx.size)).all())
        cols = None if every else device_constant(sparse_idx, torch.int32,
                                                  kmap.m.device)
        out = out + weight_stationary(
            features, kmap.m, _take(weights, sparse_idx, 0),
            capacity=ws_capacity, backend=backend, bm=bm, bn=bn,
            self_transpose=self_transpose, cols=cols)
    return out


# ---------------------------------------------------------------------------
# analytic bytes model (the cost-model tuner and the benchmarks)
# ---------------------------------------------------------------------------

def hbm_bytes_model(M: int, Kd: int, Cin: int, Cout: int, itemsize: int = 4,
                    *, backend: str = "torch", dataflow: str = "os",
                    nnz: int | None = None,
                    capacity: int | None = None) -> dict:
    """Modelled device-memory bytes of one layer's feature computation
    (the reference's ``hbm_bytes_model``; ``"cuda"`` there is
    ``"pallas"``, ``"torch"`` is ``"xla"``).

    ``"cuda"``: the fused kernels read each valid pair's input row once
    and never write a gathered intermediate. ``"torch"``: the plain
    versions gather every (row, offset) — OS ``[M, Kd, Cin]``, WS ``Kd``
    columns of ``capacity`` rows — and write and re-read the
    intermediate; WS also passes over the ``[M, Cout]`` accumulator per
    offset. Weights and the output count once either way. ``nnz`` is the
    number of valid map entries (default ``M·Kd``)."""
    nnz = M * Kd if nnz is None else int(nnz)
    w_bytes = Kd * Cin * Cout * itemsize
    out_bytes = M * Cout * itemsize
    if backend == "cuda":
        gather, intermediate = nnz * Cin * itemsize, 0
    elif dataflow == "os":
        gather = M * Kd * Cin * itemsize
        intermediate = 2 * M * Kd * Cin * itemsize
    else:
        cap = M if capacity is None else int(capacity)
        gather = Kd * cap * Cin * itemsize
        intermediate = Kd * (cap * Cin + 2 * M * Cout) * itemsize
    return {
        "total": gather + intermediate + w_bytes + out_bytes,
        "gather": gather,
        "intermediate": intermediate,
        "weights": w_bytes,
        "out": out_bytes,
    }
