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
