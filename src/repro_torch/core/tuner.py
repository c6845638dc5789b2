"""One-time per-layer tuning (Spira §5.4), torch port of
``repro.core.tuner``.

As in the paper: take a sample point cloud, try each layer's candidate
configurations and keep the best, once, before serving. Tuned axes,
persisted on the layer's :class:`SpConvSpec` by :func:`apply_tuning`:

* ``t`` — the hybrid threshold ∈ {0, s_p, …, L1NormMax + 1};
* ``backend`` — ``"torch"`` (the plain versions, which materialise the
  gathered features) or ``"cuda"`` (the fused kernels); the reference's
  ``"xla"`` and ``"pallas"``. A session tunes only its device's own: the
  plain versions never serve on the card;
* ``(bm, bn)`` — tiles, swept as given (the session passes ``(0, 0)``
  only: the OS kernel's Cout tile is ``_tile_for``'s, never tuned per M);
* ``W`` — the search window, sized exactly on the host from the sorted
  coordinates (:func:`plan_superwindow` for the superwindow search,
  :func:`plan_window` for the per-group one), no measurement needed;
* ``symmetry`` — the submanifold half-search on or off.

Two modes:

* ``measure`` — wall-clock each configuration of the layer on this device
  (one warm-up call, which also absorbs a first kernel build, then
  ``repeats`` calls, each ended by a device sync on the card);
* ``cost_model`` — analytic: OS ∝ Σ_dense |Vq|·Cin·Cout (MACs of invalid
  entries included), WS ∝ Σ_sparse nnz_k·Cin·Cout plus merge traffic,
  plus :func:`~repro_torch.core.dataflow.hbm_bytes_model`'s bytes per
  backend. Its weights are a :class:`CostConstants`:
  ``REFERENCE_COSTS`` are the reference's defaults, ``H100_COSTS`` the
  card's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .dataflow import hbm_bytes_model, hybrid
from .kernel_map import KernelMap, l1_norm_max, l1_partition
from .zdelta import symmetry_anchor_count


@dataclasses.dataclass(frozen=True)
class CostConstants:
    """Weights of the cost model, each in MACs (one multiply-add of the
    sparse convolution):

    * ``merge_cost_rows`` — one WS merge element (one pair's add into one
      output channel);
    * ``byte_cost_macs`` — one element of device-memory traffic (the model
      divides bytes by the item size);
    * ``scatter_cost_steps`` — one mirror-scatter element of the
      half-search, in binary-search compare steps."""

    merge_cost_rows: float = 4.0
    byte_cost_macs: float = 30.0
    scatter_cost_steps: float = 8.0


REFERENCE_COSTS = CostConstants()

# The H100's, from its peaks (PERF.md §6): HBM3 at 3.35 TB/s, fp32 on the
# CUDA cores at 67 TFLOP/s, 3xTF32 on the tensor cores at 165 TFLOP/s
# (bf16: 989). The OS and WS kernels multiply in 3xTF32, so one MAC takes
# 2 / 165e12 s.
# * merge: an fp32 add on the CUDA cores, 1 / 67e12 s:
#   165 / (2 · 67) = 1.231 MACs;
# * an fp32 element of traffic, 4 / 3.35e12 s: 4 · 165 / (2 · 3.35) =
#   98.51 MACs;
# * a mirror-scatter element is a random int32 store, which moves a whole
#   32-byte sector; a compare step reads one 4-byte word of a window
#   staged in order: 32 / 4 = 8 steps, the reference's value.
H100_COSTS = CostConstants(merge_cost_rows=165 / (2 * 67),
                           byte_cost_macs=4 * 165 / (2 * 3.35),
                           scatter_cost_steps=32 / 4)


def device_backends(x: torch.Tensor) -> Tuple[str, ...]:
    """The backends a tuning on ``x``'s device sweeps: the kernels on the
    card, the plain versions on the CPU."""
    return ("cuda",) if x.device.type == "cuda" else ("torch",)


def _wall(fn: Callable[[], object], repeats: int, device) -> float:
    """Mean wall seconds of ``fn()`` over ``repeats`` calls after one
    warm-up call; on the card each call ends in a device sync."""
    on_card = torch.device(device).type == "cuda"

    def run():
        fn()
        if on_card:
            torch.cuda.synchronize(device)

    run()
    tic = time.perf_counter()
    for _ in range(repeats):
        run()
    return (time.perf_counter() - tic) / repeats


@dataclasses.dataclass
class TuneResult:
    t_best: int
    per_t: dict     # t -> seconds (or model cost)
    mode: str


def candidate_ts(K: int, stride: int) -> list[int]:
    """The multiples of s_p in (0, L1NormMax] and the two ends (0: full WS,
    L1NormMax + 1: full OS)."""
    lmax = l1_norm_max(K, stride)
    return [0] + list(range(stride, lmax + 1, stride)) + [lmax + 1]


@torch.no_grad()
def tune_threshold_measure(features: torch.Tensor, kmap: KernelMap,
                           weights: torch.Tensor, *, K: int, stride: int,
                           ws_capacity: int, repeats: int = 3) -> TuneResult:
    """Wall-clock the hybrid dataflow at every candidate ``t``."""
    per_t = {}
    for t in candidate_ts(K, stride):
        per_t[t] = _wall(lambda t=t: hybrid(
            features, kmap, weights, K=K, stride=stride, t=t,
            ws_capacity=ws_capacity), repeats, features.device)
    return TuneResult(t_best=min(per_t, key=per_t.get), per_t=per_t,
                      mode="measure")


def _counts(kmap: KernelMap) -> np.ndarray:
    return kmap.column_counts().cpu().numpy().astype(np.float64)


def tune_threshold_cost_model(kmap: KernelMap, *, K: int, stride: int,
                              cin: int, cout: int,
                              merge_cost_rows: float = 4.0) -> TuneResult:
    """The MAC model of every candidate ``t`` (module doc)."""
    counts = _counts(kmap)
    n_out = float(kmap.out_count)
    per_t = {}
    for t in candidate_ts(K, stride):
        dense_idx, sparse_idx = l1_partition(K, stride, t)
        os_macs = len(dense_idx) * n_out * cin * cout          # unfiltered
        ws_macs = counts[sparse_idx].sum() * cin * cout        # filtered
        ws_merge = counts[sparse_idx].sum() * cout * merge_cost_rows
        per_t[t] = os_macs + ws_macs + ws_merge
    return TuneResult(t_best=min(per_t, key=per_t.get), per_t=per_t,
                      mode="cost_model")


# ---------------------------------------------------------------------------
# joint (t, backend, bm, bn, W) layer tuning
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerTuneResult:
    t_best: int
    backend: str
    bm: int
    bn: int
    window: int
    per_config: dict   # (t, backend, bm, bn) -> seconds (or model cost)
    mode: str
    # the half-search decision: None = not evaluated (apply_tuning keeps
    # the spec's setting)
    symmetry: Optional[bool] = None
    sym_times: Optional[Tuple[float, float]] = None   # (full, half) seconds


def _plan_window_from_bounds(inputs, outputs, bm: int, span_fn) -> int:
    """Shared body of :func:`plan_window` and :func:`plan_superwindow`, on
    the host (one copy of each coordinate set). Tiles the output rows as
    the plan does (PAD-padded to a multiple of ``bm``), asks
    ``span_fn(first_row, last_valid_row)`` for each real tile's (lo, hi)
    query bounds and returns the smallest window holding a word >= every
    hi (so the overflow test cannot fire), or reaching the array's end.
    PAD tiles are skipped: the kernels search nothing there."""
    from .voxel import pad_value

    arr = inputs.packed.cpu().numpy().astype(np.int64)
    n = arr.shape[0]
    outp = outputs.packed.cpu().numpy()
    pad = pad_value(outp.dtype)
    mcap = outp.shape[0]
    mcap2 = ((mcap + bm - 1) // bm) * bm
    padded = np.full((mcap2,), pad, outp.dtype)
    padded[:mcap] = outp
    out2d = padded.reshape(mcap2 // bm, bm).astype(np.int64)
    valid_tile = out2d[:, 0] != pad        # pads sort last: tail tiles only
    if not valid_tile.any():
        return 1
    last = np.where(out2d != pad, out2d, np.int64(-(2 ** 62))).max(axis=1)
    lo, hi = span_fn(out2d[:, 0], last)
    start = np.searchsorted(arr, lo[valid_tile], side="left")
    first_ge = np.searchsorted(arr, hi[valid_tile], side="left")
    need = np.where(first_ge < n, first_ge + 1, n) - start
    return max(1, min(int(need.max()), n))


def plan_window(inputs, outputs, packed_anchors: torch.Tensor, zstep: int,
                *, K: int, bm: int = 128) -> int:
    """Exact smallest overflow-free window of the per-group search
    (engine ``"zdelta_cuda_window"``): per (tile, anchor group) the
    queries span ``first_row + anchor`` to
    ``last_valid_row + anchor + (K − 1)·zstep``."""
    anchors = packed_anchors.cpu().numpy().astype(np.int64)

    def span(first, last):
        return (first[:, None] + anchors[None, :],
                last[:, None] + anchors[None, :] + (K - 1) * int(zstep))

    return _plan_window_from_bounds(inputs, outputs, bm, span)


def plan_superwindow(inputs, outputs, packed_anchors: torch.Tensor,
                     zstep: int, *, K: int, bm: int = 128) -> int:
    """Exact smallest overflow-free superwindow (engine ``"zdelta_cuda"``):
    one window per output tile, from its smallest query (first row +
    smallest anchor) to its largest (last valid row + largest anchor +
    (K − 1)·zstep). The kernels stage at most ``max_window`` words; the
    session holds a larger W to that when it writes the spec."""
    anchors = packed_anchors.cpu().numpy().astype(np.int64)

    def span(first, last):
        return (first + anchors[0],
                last + anchors[-1] + (K - 1) * int(zstep))

    return _plan_window_from_bounds(inputs, outputs, bm, span)


@torch.no_grad()
def tune_symmetry_measure(coords, *, K: int, repeats: int = 3,
                          engine: str = "zdelta") -> tuple:
    """Wall-clock the half-search (and its mirror scatter) against the full
    search of a submanifold layer on ``engine``'s own search
    (``network_plan.zdelta_engine_map``; on the card the CUDA search for
    ``"zdelta_cuda"``). Returns ``(half_wins, t_full, t_half)``."""
    from .network_plan import zdelta_engine_map

    inputs, outputs, anchors, zstep = coords
    times = [_wall(lambda sym=sym: zdelta_engine_map(
        inputs, outputs, anchors, zstep, K=K, engine=engine, symmetric=sym),
        repeats, inputs.packed.device) for sym in (False, True)]
    t_full, t_half = times
    return t_half < t_full, t_full, t_half


@torch.no_grad()
def tune_layer_measure(features: torch.Tensor, kmap: KernelMap,
                       weights: torch.Tensor, *, K: int, stride: int,
                       ws_capacity: int,
                       backends: Optional[Sequence[str]] = None,
                       tiles: Sequence[Tuple[int, int]] = ((0, 0),),
                       repeats: int = 3, coords: Optional[tuple] = None,
                       submanifold: bool = False,
                       engine: str = "zdelta_cuda") -> LayerTuneResult:
    """Joint wall-clock sweep over (t, backend, bm, bn); ``backends``
    defaults to the device's own (:func:`device_backends`). With
    ``coords = (inputs, outputs, anchors, zstep)``: W sized exactly for
    ``engine``'s search (:func:`plan_window` for the per-group engine,
    :func:`plan_superwindow` otherwise), and for a submanifold layer the
    half-search decided by :func:`tune_symmetry_measure` on ``engine``
    (not evaluated on the engines without a half-search)."""
    per = {}
    for backend in backends or device_backends(features):
        for bm, bn in tiles:
            for t in candidate_ts(K, stride):
                per[(t, backend, bm, bn)] = _wall(
                    lambda t=t, backend=backend, bm=bm, bn=bn: hybrid(
                        features, kmap, weights, K=K, stride=stride, t=t,
                        ws_capacity=ws_capacity, backend=backend, bm=bm,
                        bn=bn),
                    repeats, features.device)
    t_best, backend, bm, bn = min(per, key=per.get)
    window = 0
    if coords:
        plan_fn = (plan_window if engine == "zdelta_cuda_window"
                   else plan_superwindow)
        window = plan_fn(*coords, K=K)
    symmetry, sym_times = None, None
    if submanifold and coords and engine in ("zdelta", "zdelta_cuda"):
        symmetry, t_full, t_half = tune_symmetry_measure(
            coords, K=K, repeats=repeats, engine=engine)
        sym_times = (t_full, t_half)
    return LayerTuneResult(t_best=t_best, backend=backend, bm=bm, bn=bn,
                           window=window, per_config=per, mode="measure",
                           symmetry=symmetry, sym_times=sym_times)


def tune_layer_cost_model(kmap: KernelMap, *, K: int, stride: int, cin: int,
                          cout: int, itemsize: int = 4,
                          backends: Sequence[str] = ("torch", "cuda"),
                          merge_cost_rows: float = 4.0,
                          byte_cost_macs: float = 30.0,
                          submanifold: bool = False,
                          scatter_cost_steps: float = 8.0
                          ) -> LayerTuneResult:
    """Analytic joint (t, backend) choice: the MAC model of
    :func:`tune_threshold_cost_model` plus the bytes model per backend
    (tiles are not modelled: 0, the default). For a submanifold layer the
    half-search saves (K² − ⌈K²/2⌉ − 1)·M anchor searches of ~log2 M
    compare steps each and pays a ⌈K³/2⌉·M-element mirror scatter. The
    defaults are the reference's constants (``REFERENCE_COSTS``)."""
    counts = _counts(kmap)
    n_out = float(kmap.out_count)
    mcap = kmap.m.shape[0]
    per = {}
    for backend in backends:
        for t in candidate_ts(K, stride):
            dense_idx, sparse_idx = l1_partition(K, stride, t)
            macs = (len(dense_idx) * n_out * cin * cout
                    + counts[sparse_idx].sum() * cin * cout
                    + counts[sparse_idx].sum() * cout * merge_cost_rows)
            bts = 0.0
            if len(dense_idx):
                bts += hbm_bytes_model(
                    mcap, len(dense_idx), cin, cout, itemsize, backend=backend,
                    dataflow="os", nnz=int(counts[dense_idx].sum()))["total"]
            if len(sparse_idx):
                bts += hbm_bytes_model(
                    mcap, len(sparse_idx), cin, cout, itemsize, backend=backend,
                    dataflow="ws", nnz=int(counts[sparse_idx].sum()),
                    capacity=int(counts.max()) if counts.size else mcap
                )["total"]
            per[(t, backend, 0, 0)] = macs + bts * byte_cost_macs / itemsize
    t_best, backend, bm, bn = min(per, key=per.get)
    symmetry = None
    if submanifold:
        saved_steps = (K * K - symmetry_anchor_count(K)) * np.log2(max(2, mcap))
        scatter_steps = (K ** 3 // 2) * scatter_cost_steps
        symmetry = bool(saved_steps > scatter_steps)
    return LayerTuneResult(t_best=t_best, backend=backend, bm=bm, bn=bn,
                           window=0, per_config=per, mode="cost_model",
                           symmetry=symmetry)


# ---------------------------------------------------------------------------
# the segment engine's backend (train-mode objective: step time)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SegmentTuneResult:
    """Tuned segment-engine backend (``kernels.segsum``)."""
    backend: str
    per_backend: dict            # backend -> seconds (forward + backward)
    mode: str


def tune_segment_backend_measure(x: torch.Tensor, seg: tuple, *, q: int = 64,
                                 backends: Optional[Sequence[str]] = None,
                                 repeats: int = 3) -> SegmentTuneResult:
    """Wall-clock one value-and-gradient step of the segment sum (forward
    sum, then its transposed backward: training doubles the engine's
    traffic) per backend and keep the fastest. Both backends compute the
    same canonical schedule, so the choice moves no bit. ``backends``
    defaults to the device's own."""
    from ..kernels.segsum import SegmentSpec, segment_sum

    sid, starts, counts, S = seg
    per = {}
    for backend in backends or device_backends(x):
        sp = SegmentSpec(backend=backend, q=q)

        def step(sp=sp):
            with torch.enable_grad():
                v = x.detach().requires_grad_(True)
                s = segment_sum(v, sid, starts, counts, num_segments=S,
                                spec=sp)
                (s * s).sum().backward()
            return v.grad

        per[backend] = _wall(step, repeats, x.device)
    return SegmentTuneResult(backend=min(per, key=per.get), per_backend=per,
                             mode="measure")


def apply_tuning(spec, result: LayerTuneResult):
    """Persist a tune result on a layer spec (returns a new spec)."""
    return dataclasses.replace(
        spec, t=result.t_best, backend=result.backend, bm=result.bm,
        bn=result.bn, window=result.window,
        symmetry=(spec.symmetry if result.symmetry is None
                  else result.symmetry))
