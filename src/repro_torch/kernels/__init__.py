"""Hand-written Hopper kernels of the engine's hot path, each beside its
plain PyTorch version and a launch counter on its wrapper:

  zdelta_window      — superwindow and per-group window z-delta
                       kernel-map searches (csrc/zdelta_superwindow.cu,
                       csrc/zdelta_window.cu) and the exact repair of
                       their overflowed cells; the repair is port-only,
                       the JAX package runs it in XLA
                       (csrc/zdelta_repair.cu)
  spconv_gather_gemm — output-stationary implicit GEMM, gather fused in
                       (csrc/spconv_gather_gemm.cu)
  ws_scatter_gemm    — weight-stationary pair GEMM + ordered merge
                       (csrc/ws_scatter_gemm.cu)
  segsum             — segment sums under the canonical add schedule
                       (csrc/segsum.cu)
  masked_group_gemm  — the unfused OS baseline over a gathered
                       [M, Kd, Cin] tensor (csrc/masked_group_gemm.cu)
  dw_gather_gemm     — the per-offset weight gradient with the gather
                       fused in and a fixed row grouping; port-only, no
                       TPU counterpart (csrc/dw_gather_gemm.cu)
  flash_attention    — causal or full softmax attention with an online
                       softmax over KV tiles, GQA by index
                       (csrc/flash_attention.cu), and its backward (dQ,
                       then dK/dV; port-only, the JAX package
                       differentiates attention in XLA:
                       csrc/flash_attention_bwd.cu)

``ops.resolve_backend`` decides kernel or plain version by backend string
and tensor device; ``_build`` compiles ``csrc/`` with nvcc on first use;
``opcount`` holds the hooks through which the kernels' closed forms reach
an operation counter (``launch.op_analysis``).
"""
from . import (dw_gather_gemm, flash_attention, masked_group_gemm, ops,
               segsum, spconv_gather_gemm, ws_scatter_gemm, zdelta_window)
from .segsum import (SegmentSpec, segment_sum, segment_gather,
                     segment_moments, segments_from_sizes,
                     segment_call_count, reset_segment_calls)

# kernel name -> the wrapper that launches it (and carries its counter)
LAUNCHERS = {
    "zdelta_superwindow_search": zdelta_window.zdelta_superwindow_cuda,
    "spconv_gather_gemm": spconv_gather_gemm.spconv_gather_gemm,
    "segment_sum": segsum.segment_sum_cuda,
    "ws_scatter_gemm": ws_scatter_gemm.ws_scatter_gemm,
    "zdelta_window_search": zdelta_window.zdelta_window_cuda,
    "masked_group_gemm": masked_group_gemm.masked_group_gemm,
    "dw_gather_gemm": dw_gather_gemm.dw_gather_gemm,
    "flash_attention": flash_attention.flash_attention,
    "flash_attention_bwd": flash_attention.flash_attention_bwd,
    "zdelta_repair": zdelta_window.zdelta_repair_cuda,
}


def launch_counts() -> dict:
    """Launches of each kernel wrapper so far, by kernel name."""
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def reset_launch_counts() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0
