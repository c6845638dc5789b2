"""Segmented-reduction engine: per-scene sums over batch-major rows, with
one canonical add schedule (torch port of ``repro.kernels.segsum``).

The schedule is the bit contract (``repro.kernels.segsum`` module doc): rows
of a segment are chunked by their position relative to the segment start
(``rel // q``); within a chunk fp32 adds run strictly in row order from
+0.0; chunk partials combine strictly in chunk order from +0.0; rows
outside every segment are skipped. Every add is one IEEE fp32 add, so any
two implementations agree bit for bit, and a segment's sum does not depend
on where its rows sit (alignment invariance: batch of B == B single runs)
or on PAD rows appended behind it (zero-extension invariance).

Replaces the TPU kernel ``repro/kernels/segsum.py`` (``segment_sum_pallas``,
``_segsum_kernel``) with ``csrc/segsum.cu``: three kernels on the stream —
the chunk offsets (a scan of ``ceil(counts / q)`` on the card), the chunk
partials (one thread per used slot and channel, its row loads issued ahead
of its adds) and the combine (one warp per segment and 32 channels,
streaming the partials through shared memory). Bound by bytes on the H100
(every valid row is read once, one add per element). The fp32 sums use no
atomics, shuffles or trees, and no fast math, so the kernel is bitwise
equal to :func:`segment_sum_torch`. The wrapper builds no chunk table,
reads bf16 rows natively (the kernel widens them exactly) and never waits
on the card, as CUDA-graph capture needs.

:func:`segment_sum_torch` is the plain version: ``segment_sum_xla`` in
torch — the chunk table, one gather, a q-step masked add chain, then the
combine loop. It uses no ``torch.sum``; on the CPU it is bitwise equal to
the JAX reference.

:func:`relu_bn_cuda` is the fused ReLU + per-scene BN epilogue of an
inference forward, two more kernels of ``csrc/segsum.cu``: the moments
(the chunk partials of the schedule above reading ``z = relu(x + bias)``
with PAD rows masked, summing ``z`` and ``z²`` from one load) and the
apply (``(z − mean[sid]) · inv[sid]``, +0 on rows outside every segment),
with :func:`bn_stats` between them. It is bitwise the chain of torch ops
it replaces (``models.pointcloud``'s bias add, row mask and ``_relu_bn``)
and records no autograd graph. Its other orders (``NORM_ORDERS``) take
the moments of the output itself and apply the standardisation first:
then a ReLU (``bn_relu``), nothing (``bn``), or a residual operand added
and the sum's ReLU (``bn_add_relu``), bitwise ``models.pointcloud``'s
``_bn_relu``, ``_bn`` and ``_bn_add_relu``.

:func:`segment_sum` and :func:`segment_gather` are each other's
transposes and carry that as their backward passes (the reference's
custom-VJP pair), so gradients of every per-scene statistic reduce under
the same schedule, never through a scatter-add.

Input contract: ``sid`` is nondecreasing with ``counts[b]`` rows of value
``b`` starting at ``starts[b]``; rows outside every segment (the PAD tail)
carry ``sid >= num_segments`` (``models.pointcloud.packed_segments``).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import opcount
from . import _build
from .ops import resolve_backend

# calls of segment_sum (one per BN layer on the forward pass)
SEGMENT_CALLS = {"count": 0}


def reset_segment_calls() -> None:
    SEGMENT_CALLS["count"] = 0


def segment_call_count() -> int:
    return SEGMENT_CALLS["count"]


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    """Segmented-reduction config: ``backend`` ("auto" | "torch" | "cuda")
    and the chunk length ``q`` of the canonical schedule (part of the bit
    contract: one network uses one spec)."""

    backend: str = "auto"
    q: int = 64


def chunk_offsets(counts: torch.Tensor, q: int):
    """Per segment its chunk count ``nch = ceil(counts / q)`` and first
    chunk slot ``choff`` [S + 1] (``choff[S]`` is the number of used
    slots): what the card's ``chunk_offsets`` kernel computes."""
    i32 = torch.int32
    nch = torch.div(counts.to(i32) + (q - 1), q, rounding_mode="floor")
    choff = torch.cat([torch.zeros(1, dtype=i32, device=counts.device),
                       torch.cumsum(nch, 0).to(i32)])
    return nch, choff


def _chunk_table(starts: torch.Tensor, counts: torch.Tensor, cap: int,
                 q: int):
    """The canonical chunk enumeration, scatter-free (as
    ``segment_sum_xla``): per segment its chunk count ``nch`` and first
    chunk slot ``choff`` [S + 1]; per slot of ``n2 = cap // q + S`` its
    start row and length (0 for unused slots). The card derives the same
    slots from ``choff`` in its kernels."""
    i32 = torch.int32
    S = starts.shape[0]
    dev = starts.device
    starts = starts.to(i32)
    counts = counts.to(i32)
    nch, choff = chunk_offsets(counts, q)
    n2 = cap // q + S
    c = torch.arange(n2, dtype=i32, device=dev)
    # owning segment per slot: empty segments (duplicate offsets) resolve to
    # the next nonempty owner via side="right"
    seg = (torch.searchsorted(choff, c, side="right", out_int32=True)
           - 1).clamp(0, S - 1).long()
    j = c - choff[seg]
    chunk_start = starts[seg] + j * q
    chunk_len = torch.where(c < choff[S],
                            (counts[seg] - j * q).clamp(0, q), 0).to(i32)
    return nch, choff, chunk_start.to(i32), chunk_len, n2


def segment_sum_torch(x: torch.Tensor, sid: torch.Tensor,
                      starts: torch.Tensor, counts: torch.Tensor, *,
                      num_segments: int, q: int = 64) -> torch.Tensor:
    """Plain version: segment sums [S, C] fp32 under the canonical
    schedule."""
    cap, C = x.shape
    S = num_segments
    nch, choff, chunk_start, chunk_len, n2 = _chunk_table(starts, counts,
                                                          cap, q)
    dev = x.device
    idx = (chunk_start[:, None].long()
           + torch.arange(q, device=dev)[None, :]).clamp(0, cap - 1)
    g = x[idx].float()                                     # [n2, q, C]
    p = torch.zeros((n2, C), dtype=torch.float32, device=dev)
    for t in range(q):
        p = torch.where((t < chunk_len)[:, None], p + g[:, t, :], p)
    # every segment's chunk partials in chunk order, +0.0 past its own
    # chunks: no segment has more than the buffer's ceil(cap / q), a bound
    # read from no tensor (the plain version makes no host read either).
    # Adding +0.0 leaves every sum as it is: it starts at +0.0 and so is
    # never -0.0, the one value an added +0.0 would change.
    J = -(-cap // q)
    jj = torch.arange(J, device=dev)
    rows = p[(choff[:-1, None].long() + jj[None, :]).clamp(0, n2 - 1)]
    rows = torch.where((jj[None, :] < nch[:, None])[..., None], rows, 0.0)
    acc = torch.zeros((S, C), dtype=torch.float32, device=dev)
    for j in range(J if S else 0):
        acc = acc + rows[:, j]
    return acc


_SIG = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_fns: dict = {}


def segment_sum_cuda(x: torch.Tensor, sid: torch.Tensor,
                     starts: torch.Tensor, counts: torch.Tensor, *,
                     num_segments: int, q: int = 64) -> torch.Tensor:
    """Launch the CUDA kernels on CUDA ``x``; same contract and bits as
    :func:`segment_sum_torch`. fp32 and bf16 rows are read as they are
    (bf16 widened exactly in the kernel); other floats are widened to fp32
    first, as the plain version does. No host sync."""
    if x.device.type != "cuda":
        raise ValueError("segment_sum_cuda launches a CUDA kernel; got a "
                         f"tensor on {x.device}")
    if not x.is_floating_point():
        raise TypeError(f"segment_sum_cuda takes float rows, got {x.dtype}")
    cap, C = x.shape
    S = num_segments
    if starts.numel() != S or counts.numel() != S:
        raise ValueError(f"starts/counts hold {starts.numel()}/"
                         f"{counts.numel()} segments, expected {S}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    x = x.contiguous()
    dev = x.device
    starts = starts.to(device=dev, dtype=torch.int32).contiguous()
    counts = counts.to(device=dev, dtype=torch.int32).contiguous()
    n2 = cap // q + S
    choff = torch.empty(S + 1, dtype=torch.int32, device=dev)
    partial = torch.empty((n2, C), dtype=torch.float32, device=dev)
    out = torch.empty((S, C), dtype=torch.float32, device=dev)
    fn = _fns.get("fn")
    if fn is None:
        fn = _fns["fn"] = _build.function("spira_segment_sum", _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), C, q,
             starts.data_ptr(), counts.data_ptr(), S, n2, choff.data_ptr(),
             partial.data_ptr(), out.data_ptr(), stream)
    segment_sum_cuda.launches += 1
    _build.check(err, "segment_sum")
    return out


segment_sum_cuda.launches = 0


def _segment_sum_impl(x: torch.Tensor, sid: torch.Tensor,
                      starts: torch.Tensor, counts: torch.Tensor,
                      num_segments: int, sp: SegmentSpec) -> torch.Tensor:
    SEGMENT_CALLS["count"] += 1
    if resolve_backend(sp.backend, x):
        return segment_sum_cuda(x, sid, starts, counts,
                                num_segments=num_segments, q=sp.q)
    return segment_sum_torch(x, sid, starts, counts,
                             num_segments=num_segments, q=sp.q)


def _gather_rows(v: torch.Tensor, sid: torch.Tensor, S: int) -> torch.Tensor:
    """Row ``sid[r]`` of ``v`` on every row; 0 where ``sid >= S``."""
    r = v[sid.clamp(0, S - 1).long()]
    return torch.where((sid < S)[:, None], r, torch.zeros((), dtype=v.dtype,
                                                          device=v.device))


class _SegmentSum(torch.autograd.Function):
    """Segment sum whose backward is the elementwise segment gather of the
    cotangent (exact at any alignment and capacity)."""

    @staticmethod
    def forward(ctx, x, sid, starts, counts, num_segments, sp):
        ctx.save_for_backward(sid)
        ctx.S = num_segments
        ctx.dtype = x.dtype
        return _segment_sum_impl(x, sid, starts, counts, num_segments, sp)

    @staticmethod
    def backward(ctx, g):
        (sid,) = ctx.saved_tensors
        return (_gather_rows(g, sid, ctx.S).to(ctx.dtype), None, None, None,
                None, None)


class _SegmentGather(torch.autograd.Function):
    """Segment gather whose backward is this engine's segment sum of the
    cotangent: the transposed reduction keeps the canonical schedule, where
    autograd would otherwise add a scatter-add."""

    @staticmethod
    def forward(ctx, v, sid, starts, counts, num_segments, sp):
        ctx.save_for_backward(sid, starts, counts)
        ctx.S = num_segments
        ctx.sp = sp
        ctx.dtype = v.dtype
        return _gather_rows(v, sid, num_segments)

    @staticmethod
    def backward(ctx, g):
        sid, starts, counts = ctx.saved_tensors
        dv = _segment_sum_impl(g, sid, starts, counts, ctx.S, ctx.sp)
        return dv.to(ctx.dtype), None, None, None, None, None


def segment_sum(x: torch.Tensor, sid: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, *, num_segments: int,
                spec: SegmentSpec | None = None) -> torch.Tensor:
    """Per-segment column sums [num_segments, C] (fp32) of ``x`` [cap, C]
    under the canonical schedule; the kernel or the plain version by
    ``spec.backend`` (``kernels.ops.resolve_backend``). Differentiable: the
    backward is :func:`segment_gather`'s elementwise broadcast."""
    with opcount.kernel("segment_sum", 0.0, x.numel() * x.element_size()
                        + 4 * (sid.numel() + num_segments * x.shape[-1])):
        return _SegmentSum.apply(x, sid, starts, counts, num_segments,
                                 spec or SegmentSpec())


def segment_gather(v: torch.Tensor, sid: torch.Tensor, starts: torch.Tensor,
                   counts: torch.Tensor, *, num_segments: int,
                   spec: SegmentSpec | None = None) -> torch.Tensor:
    """Broadcast per-segment rows ``v`` [S, C] onto the row buffer (rows
    outside every segment get 0). Differentiable: the backward is
    :func:`segment_sum` with the same spec, never a scatter-add."""
    return _SegmentGather.apply(v, sid, starts, counts, num_segments,
                                spec or SegmentSpec())


def segments_from_sizes(sizes, cap: int):
    """Host-side synthetic segmentation honoring the input contract:
    contiguous segments of the given sizes from row 0, PAD tail with the
    sentinel id ``S``. Returns numpy ``(sid [cap], starts [S], counts
    [S])``."""
    S = len(sizes)
    if sum(sizes) > cap:
        raise ValueError(f"segment sizes sum to {sum(sizes)} > cap {cap}")
    sid = np.full(cap, S, np.int32)
    starts = np.zeros(S, np.int32)
    pos = 0
    for b, sz in enumerate(sizes):
        starts[b] = pos
        sid[pos:pos + sz] = b
        pos += sz
    return sid, starts, np.asarray(sizes, np.int32)


def bn_stats(sx: torch.Tensor, sx2: torch.Tensor,
             counts: torch.Tensor) -> torch.Tensor:
    """Per-segment ``concat([mean, inv])`` [S, 2C] fp32 from the moments
    ``Σz``, ``Σz²`` [S, C] and the row counts: one-pass var = E[z²] −
    mean², clamped at 0, ``inv = rsqrt(var + 1e-5)``."""
    denom = counts.to(torch.float32).clamp(min=1.0)[:, None]
    mean = sx / denom
    var = (sx2 / denom - mean * mean).clamp(min=0.0)
    inv = torch.rsqrt(var + 1e-5)
    return torch.cat([mean, inv], dim=1)


_MOMENTS_SIG = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_APPLY_SIG = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
# the fused epilogue's norm orders; the index is csrc/segsum.cu's Order
NORM_ORDERS = ("relu_bn", "bn_relu", "bn", "bn_add_relu")


def _ptr(t):
    return None if t is None else t.data_ptr()


def relu_bn_cuda(x: torch.Tensor, count: torch.Tensor,
                 seg: tuple | None = None, *,
                 bias: torch.Tensor | None = None, mask: bool = False,
                 q: int = 64, order: str = "relu_bn",
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """The fused epilogue of one convolution on CUDA fp32 ``x`` [cap, C]
    (the output before the bias): ``z = relu(x + bias)``, its rows at or
    past ``count`` set to +0 before the ReLU when ``mask``, then per-scene
    standardisation as ``models.pointcloud._relu_bn`` computes it, bitwise.
    ``seg = (sid, starts, counts, S)``; ``None`` is the single scene over
    the rows below ``count``. Two kernels with :func:`bn_stats` between;
    no host sync, no autograd. ``order`` (``NORM_ORDERS``) other than
    ``relu_bn`` standardises ``x`` itself (no bias, no mask) and then takes
    the ReLU (``bn_relu``), nothing (``bn``) or the ReLU of the sum with
    ``residual`` [cap, C] fp32 (``bn_add_relu``), bitwise
    ``models.pointcloud._bn_relu`` / ``_bn`` / ``_bn_add_relu``."""
    if x.device.type != "cuda":
        raise ValueError("relu_bn_cuda launches a CUDA kernel; got a tensor "
                         f"on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"relu_bn_cuda takes fp32 rows, got {x.dtype}")
    if order not in NORM_ORDERS:
        raise ValueError(f"order {order!r} is not one of {NORM_ORDERS}")
    if order != "relu_bn" and (bias is not None or mask):
        raise ValueError(f"the {order} epilogue takes no bias or mask")
    if (residual is not None) != (order == "bn_add_relu"):
        raise ValueError("a residual operand goes with bn_add_relu alone")
    if residual is not None:
        if residual.dtype != torch.float32 or residual.shape != x.shape:
            raise ValueError(f"residual {residual.dtype} "
                             f"{tuple(residual.shape)} is not fp32 "
                             f"{tuple(x.shape)}")
        residual = residual.to(x.device).contiguous()
    cap, C = x.shape
    x = x.contiguous()
    dev = x.device
    i32 = torch.int32
    count = count.to(device=dev, dtype=i32).reshape(1)
    if seg is None:
        sid = starts = None
        counts, S = count, 1
    else:
        sid, starts, counts, S = seg
        sid = sid.to(device=dev, dtype=i32).contiguous()
        starts = starts.to(device=dev, dtype=i32).contiguous()
        counts = counts.to(device=dev, dtype=i32).contiguous()
    if bias is not None:
        bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    n2 = cap // q + S
    choff = torch.empty(S + 1, dtype=i32, device=dev)
    partial = torch.empty((n2, 2 * C), dtype=torch.float32, device=dev)
    sums = torch.empty((S, 2 * C), dtype=torch.float32, device=dev)
    fns = _fns.get("relu_bn")
    if fns is None:
        fns = _fns["relu_bn"] = (
            _build.function("spira_epilogue_moments", _MOMENTS_SIG),
            _build.function("spira_epilogue_apply", _APPLY_SIG))
    moments, apply = fns
    stream = torch.cuda.current_stream(dev).cuda_stream
    mcount = count if mask else None
    o = NORM_ORDERS.index(order)
    err = moments(x.data_ptr(), _ptr(bias), _ptr(mcount), o, C, q,
                  _ptr(starts), counts.data_ptr(), S, n2, choff.data_ptr(),
                  partial.data_ptr(), sums.data_ptr(), stream)
    _build.check(err, f"{order} moments")
    stats = bn_stats(sums[:, :C], sums[:, C:], counts)
    y = torch.empty_like(x)
    vec4 = C % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in
                              (x, stats, y, *(t for t in (bias, residual)
                                              if t is not None)))
    err = apply(x.data_ptr(), _ptr(bias), _ptr(mcount), _ptr(sid),
                counts.data_ptr(), stats.data_ptr(), _ptr(residual), o, S,
                cap, C, int(vec4), y.data_ptr(), stream)
    relu_bn_cuda.launches += 1
    _build.check(err, f"{order} apply")
    return y


relu_bn_cuda.launches = 0


def segment_moments(x: torch.Tensor, sid: torch.Tensor, starts: torch.Tensor,
                    counts: torch.Tensor, *, num_segments: int,
                    spec: SegmentSpec | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) per segment in one pass: one segment sum of
    ``concat([x, x²])``."""
    C = x.shape[1]
    s = segment_sum(torch.cat([x, x * x], dim=1), sid, starts, counts,
                    num_segments=num_segments, spec=spec)
    return s[:, :C], s[:, C:]
