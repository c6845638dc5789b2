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
``_segsum_kernel``) with ``csrc/segsum.cu``: two passes, one thread per
(chunk slot, channel) and then one per (segment, channel), each a
sequential chain. Bound by bytes on the H100 (every valid row is read once,
one add per element); neighbouring channels sit on neighbouring threads so
each chain step is a coalesced row read. No atomics, shuffles or trees, and
no fast math, so the kernel is bitwise equal to :func:`segment_sum_torch`.

:func:`segment_sum_torch` is the plain version: ``segment_sum_xla`` in
torch — the chunk table, one gather, a q-step masked add chain, then the
combine loop. It uses no ``torch.sum``; on the CPU it is bitwise equal to
the JAX reference.

Input contract: ``sid`` is nondecreasing with ``counts[b]`` rows of value
``b`` starting at ``starts[b]``; rows outside every segment (the PAD tail)
carry ``sid >= num_segments`` (``models.pointcloud.packed_segments``).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

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


def _chunk_table(starts: torch.Tensor, counts: torch.Tensor, cap: int,
                 q: int):
    """The canonical chunk enumeration, scatter-free (as
    ``segment_sum_xla``): per segment its chunk count ``nch`` and first
    chunk slot ``choff`` [S + 1]; per slot of ``n2 = cap // q + S`` its
    start row and length (0 for unused slots)."""
    i32 = torch.int32
    S = starts.shape[0]
    dev = starts.device
    starts = starts.to(i32)
    counts = counts.to(i32)
    nch = torch.div(counts + (q - 1), q, rounding_mode="floor")
    choff = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                       torch.cumsum(nch, 0).to(i32)])
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
    acc = torch.zeros((S, C), dtype=torch.float32, device=dev)
    max_nch = int(nch.max()) if S else 0
    for jj in range(max_nch):
        rows = p[(choff[:-1] + jj).clamp(0, n2 - 1).long()]
        acc = torch.where((jj < nch)[:, None], acc + rows, acc)
    return acc


_SIG = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_fns: dict = {}


def segment_sum_cuda(x: torch.Tensor, sid: torch.Tensor,
                     starts: torch.Tensor, counts: torch.Tensor, *,
                     num_segments: int, q: int = 64) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA ``x``; same contract and bits as
    :func:`segment_sum_torch`. The kernel adds fp32 rows: narrower floats
    are widened first, exactly, as the plain version does."""
    if x.device.type != "cuda":
        raise ValueError("segment_sum_cuda launches a CUDA kernel; got a "
                         f"tensor on {x.device}")
    if not x.is_floating_point():
        raise TypeError(f"segment_sum_cuda takes float rows, got {x.dtype}")
    cap, C = x.shape
    S = num_segments
    nch, choff, chunk_start, chunk_len, n2 = _chunk_table(starts, counts,
                                                          cap, q)
    x = x.to(torch.float32).contiguous()
    partial = torch.empty((n2, C), dtype=torch.float32, device=x.device)
    out = torch.empty((S, C), dtype=torch.float32, device=x.device)
    fn = _fns.get("fn")
    if fn is None:
        fn = _fns["fn"] = _build.function("spira_segment_sum_f32", _SIG)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), C, chunk_start.data_ptr(), chunk_len.data_ptr(),
             n2, choff.data_ptr(), nch.data_ptr(), S, partial.data_ptr(),
             out.data_ptr(), stream)
    segment_sum_cuda.launches += 1
    _build.check(err, "segment_sum")
    return out


segment_sum_cuda.launches = 0


def segment_sum(x: torch.Tensor, sid: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, *, num_segments: int,
                spec: SegmentSpec | None = None) -> torch.Tensor:
    """Per-segment column sums [num_segments, C] (fp32) of ``x`` [cap, C]
    under the canonical schedule; the kernel or the plain version by
    ``spec.backend`` (``kernels.ops.resolve_backend``)."""
    sp = spec or SegmentSpec()
    SEGMENT_CALLS["count"] += 1
    if resolve_backend(sp.backend, x):
        return segment_sum_cuda(x, sid, starts, counts,
                                num_segments=num_segments, q=sp.q)
    return segment_sum_torch(x, sid, starts, counts,
                             num_segments=num_segments, q=sp.q)


def segment_gather(v: torch.Tensor, sid: torch.Tensor, starts: torch.Tensor,
                   counts: torch.Tensor, *, num_segments: int,
                   spec: SegmentSpec | None = None) -> torch.Tensor:
    """Broadcast per-segment rows ``v`` [S, C] onto the row buffer (rows
    outside every segment get 0)."""
    S = num_segments
    r = v[sid.clamp(0, S - 1).long()]
    return torch.where((sid < S)[:, None], r, torch.zeros((), dtype=v.dtype,
                                                          device=v.device))


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
