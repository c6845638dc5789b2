"""Hand-written Hopper kernels of the engine's hot path, each beside its
plain PyTorch version and a launch counter on its wrapper:

  zdelta_window      — superwindow z-delta kernel-map search
                       (csrc/zdelta_superwindow.cu)
  spconv_gather_gemm — output-stationary implicit GEMM, gather fused in
                       (csrc/spconv_gather_gemm.cu)
  segsum             — segment sums under the canonical add schedule
                       (csrc/segsum.cu)

``ops.resolve_backend`` decides kernel or plain version by backend string
and tensor device; ``_build`` compiles ``csrc/`` with nvcc on first use.
"""
from . import ops, segsum, spconv_gather_gemm, zdelta_window
from .segsum import (SegmentSpec, segment_sum, segment_gather,
                     segment_moments, segments_from_sizes,
                     segment_call_count, reset_segment_calls)

# kernel name -> the wrapper that launches it (and carries its counter)
LAUNCHERS = {
    "zdelta_superwindow_search": zdelta_window.zdelta_superwindow_cuda,
    "spconv_gather_gemm": spconv_gather_gemm.spconv_gather_gemm,
    "segment_sum": segsum.segment_sum_cuda,
}


def launch_counts() -> dict:
    """Launches of each kernel wrapper so far, by kernel name."""
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def reset_launch_counts() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0
