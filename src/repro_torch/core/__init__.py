"""Spira core on torch: packed-native voxel indexing + OS sparse conv."""
from .packing import BitLayout, pack, pack_offsets, unpack, offset_grid, offset_l1
from .voxel import (CoordSet, build_coord_set, downsample, downsample_all,
                    downsample_merge, pad_value, resolve_downsample_method)
from .zdelta import (zdelta_offsets, zdelta_search, zdelta_search_symmetric,
                     symmetrize_kernel_map, symmetry_anchor_count,
                     expand_half_map, reset_search_calls, search_call_count)
from .kernel_map import (KernelMap, l1_partition, l1_norm_max,
                         transpose_kernel_map)
from .dataflow import output_stationary, os_torch
from .spconv import SpConv, SpConvSpec, init_spconv, apply_spconv
from .sparse_tensor import SparseTensor, ensure_sparse_tensor
from .validate import (ValidationError, ValidationReport,
                       validate_point_cloud)
from .network_plan import NetworkPlan, build_network_plan, plan_levels
