"""Roofline terms of a dry-run cell, on one NVIDIA H100.

The port of ``repro/launch/roofline.py``. Three terms per (arch × shape ×
mesh), all *per device*:

  compute    = FLOPs / PEAK_FLOPS             (989 TFLOP/s bf16 dense)
  memory     = bytes / HBM_BW                 (3.35 TB/s HBM3)
  collective = Σ ring_bytes(op) / LINK_BW     (450 GB/s NVLink 4, one way)

The constants are the H100 SXM's, from NVIDIA's H100 data sheet (dense
rates, without sparsity, at the card's full 700 W): bf16 989 TFLOP/s on
the tensor cores, fp32 67 TFLOP/s on the CUDA cores, 3.35 TB/s of HBM3,
and NVLink 4 at 900 GB/s in both directions together, 450 GB/s each way.

The counts come from ``op_analysis.OpCounter`` (the port has no HLO: it
counts the operations the program issues on each rank). Collective bytes
follow ring algorithms, from each collective's result size and group size
g:

  all-reduce     2·S·(g−1)/g      (reduce-scatter + all-gather)
  all-gather     S·(g−1)/g        (S = full gathered result)
  reduce-scatter S_out·(g−1)
  all-to-all     S·(g−1)/g
  collective-permute  S
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

PEAK_FLOPS = 989e12         # bf16 dense, tensor cores (H100 SXM data sheet)
PEAK_FLOPS_FP32 = 67e12     # fp32, CUDA cores (H100 SXM data sheet)
HBM_BW = 3.35e12            # bytes/s, HBM3 (H100 SXM data sheet)
LINK_BW = 450e9             # bytes/s, NVLink 4 one way (900 GB/s both ways)
HBM_BYTES = 80 * 10 ** 9    # device memory of the H100 SXM (80 GB)

_DTYPE_BYTES = {torch.float64: 8, torch.float32: 4, torch.bfloat16: 2,
                torch.float16: 2, torch.float8_e4m3fn: 1,
                torch.float8_e5m2: 1, torch.int64: 8, torch.uint64: 8,
                torch.int32: 4, torch.uint32: 4, torch.int16: 2,
                torch.uint16: 2, torch.int8: 1, torch.uint8: 1,
                torch.bool: 1, torch.complex64: 8, torch.complex128: 16}


@dataclasses.dataclass
class CollectiveOp:
    op: str
    dtype: torch.dtype
    shape: tuple
    group_size: int
    result_bytes: int
    moved_bytes: float


def _ring_bytes(op: str, size: int, g: int) -> float:
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * size * (g - 1) / g
    if op == "all-gather":
        return size * (g - 1) / g
    if op == "reduce-scatter":
        return float(size) * (g - 1)
    if op == "all-to-all":
        return size * (g - 1) / g
    if op == "collective-permute":
        return float(size)
    return 0.0


def collective_op(op: str, result: torch.Tensor, g: int) -> CollectiveOp:
    """A collective of group size ``g`` whose (per-rank) result is
    ``result``, with its ring bytes."""
    size = _DTYPE_BYTES[result.dtype] * result.numel()
    return CollectiveOp(op=op, dtype=result.dtype, shape=tuple(result.shape),
                        group_size=g, result_bytes=size,
                        moved_bytes=_ring_bytes(op, size, g))


def collective_summary(ops: List[CollectiveOp]) -> Dict[str, float]:
    summary: Dict[str, float] = {}
    for o in ops:
        summary[o.op] = summary.get(o.op, 0.0) + o.moved_bytes
    summary["total"] = sum(v for k, v in summary.items() if k != "total")
    return summary


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    arg_bytes: int
    temp_bytes: int
    by_collective: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lb(self) -> float:
        """Roofline lower bound on step time = max of the three terms
        (perfect overlap assumption)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def fraction_of_roofline(self) -> float:
        """How much of the bound is the compute term — 1.0 means perfectly
        compute-bound (the best place to be)."""
        return self.t_compute / max(self.step_time_lb, 1e-30)


def analyze(counter, arg_bytes: int) -> Roofline:
    """The roofline terms of what ``counter`` (an ``op_analysis.OpCounter``
    that has run the step) counted; ``arg_bytes`` the per-device bytes of
    the step's arguments (parameters, optimizer state, caches, batch)."""
    return Roofline(flops=counter.flops, bytes_accessed=counter.bytes,
                    collective_bytes=counter.collective_bytes,
                    arg_bytes=int(arg_bytes),
                    temp_bytes=int(counter.peak_live_bytes),
                    by_collective=dict(counter.by_collective))


def model_flops(n_params_active: float, n_tokens: float,
                train: bool) -> float:
    """6·N·D for training, 2·N·D for inference forward (per whole step,
    global). Used for the MODEL_FLOPS / counted FLOPs usefulness ratio."""
    per_tok = 6.0 * n_params_active if train else 2.0 * n_params_active
    return per_tok * n_tokens


def model_flops_share(step_seconds: float, n_params_active: float,
                      n_tokens: float, train: bool = True, *,
                      devices: int = 1, peak: float = PEAK_FLOPS) -> float:
    """The whole step's model-FLOP share: :func:`model_flops` over
    (step time × the peak of ``devices`` cards)."""
    return model_flops(n_params_active, n_tokens, train) / (
        step_seconds * peak * devices)
