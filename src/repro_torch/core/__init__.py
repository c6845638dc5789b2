"""Spira core on torch: packed-native voxel indexing + adaptive-dataflow
sparse conv."""
from .packing import BitLayout, pack, pack_offsets, unpack, offset_grid, offset_l1
from .voxel import (CoordSet, build_coord_set, downsample, downsample_all,
                    downsample_merge, pad_value, resolve_downsample_method)
from .zdelta import (zdelta_offsets, zdelta_search, zdelta_search_symmetric,
                     symmetrize_kernel_map, symmetry_anchor_count,
                     expand_half_map, reset_search_calls, search_call_count,
                     simple_bsearch)
from .kernel_map import (KernelMap, density_by_l1, l1_partition,
                         l1_norm_max, transpose_kernel_map)
from .dataflow import (output_stationary, weight_stationary, hybrid,
                       hbm_bytes_model, os_torch, ws_torch, ws_kept_map,
                       rowsum, bcast_rows, rowdot_matmul)
from ..kernels.dw_gather_gemm import chunked_rowdot
from .spconv import SpConv, SpConvSpec, init_spconv, apply_spconv
from .sparse_tensor import SparseTensor, ensure_sparse_tensor
from .validate import (ValidationError, ValidationReport,
                       validate_point_cloud)
from .network_plan import (ENGINES, NetworkPlan, build_network_plan,
                           plan_levels, sequential_plan_fns)
from .tuner import (H100_COSTS, REFERENCE_COSTS, CostConstants,
                    LayerTuneResult, SegmentTuneResult, apply_tuning,
                    candidate_ts, plan_superwindow, plan_window,
                    tune_layer_cost_model, tune_layer_measure,
                    tune_segment_backend_measure, tune_threshold_cost_model,
                    tune_threshold_measure)
