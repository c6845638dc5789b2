"""Gold oracles for the sparse-convolution engine (torch port of
``repro.core.reference``).

* ``kernel_map_reference`` — an O(|Vq|·K³) dict-based kernel map on the
  host.
* ``dense_conv_reference`` / ``dense_conv_fn`` — scatter the sparse
  features into a dense grid and run ``F.conv3d`` with ``dilation`` set
  to the offset stride (the reference's ``lax.conv_general_dilated`` with
  ``rhs_dilation``); the ground truth for every dataflow's numerics.

None of them uses the engine's machinery (no packing, no sorting, no
kernel maps), so they cannot share its bugs. They are oracles, not ports
of any kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .packing import offset_grid


def kernel_map_reference(in_coords: np.ndarray, out_coords: np.ndarray,
                         K: int, stride: int) -> np.ndarray:
    """Brute-force kernel map; coords are int [N, 3] (unpacked, unique).
    Columns in ``offset_grid`` order, int32, −1 for no input."""
    table = {tuple(c): i for i, c in enumerate(in_coords.tolist())}
    offs = offset_grid(K, stride)
    m = np.full((len(out_coords), K ** 3), -1, np.int32)
    for i, q in enumerate(out_coords.tolist()):
        for k, d in enumerate(offs.tolist()):
            j = table.get((q[0] + d[0], q[1] + d[1], q[2] + d[2]))
            if j is not None:
                m[i, k] = j
    return m


def downsample_reference(coords: np.ndarray, m: int) -> np.ndarray:
    """Unique sorted ``floor(v / 2^m) * 2^m`` (lexicographic order)."""
    r = (coords >> m) << m
    return np.unique(r, axis=0)


def _grid(in_coords: np.ndarray, out_coords: np.ndarray, K: int,
          stride: int):
    """The dense box over both coordinate sets, widened by the kernel's
    reach: its low corner and its shape."""
    reach = (K - 1) // 2 * stride
    lo = np.minimum(in_coords.min(0), out_coords.min(0)) - reach
    hi = np.maximum(in_coords.max(0), out_coords.max(0)) + reach
    return lo, tuple(int(v) for v in (hi - lo + 1))


def _dense_conv(features: torch.Tensor, weights: torch.Tensor,
                ic: torch.Tensor, oc: torch.Tensor, shape: tuple, K: int,
                stride: int) -> torch.Tensor:
    """Scatter, dense convolution and gather; differentiable in
    ``features`` and ``weights``. The box is widened by the kernel's
    reach, so ``padding`` by the reach gives the reference's "SAME"."""
    cin = features.shape[1]
    cout = weights.shape[2]
    grid = features.new_zeros((*shape, cin)).index_put(
        (ic[:, 0], ic[:, 1], ic[:, 2]), features)
    grid = grid.permute(3, 0, 1, 2)[None]                # [1, cin, X, Y, Z]
    # weights [K³, cin, cout] in offset_grid order -> [cout, cin, K, K, K];
    # conv3d correlates, as the reference's conv does (no kernel flip)
    w = weights.reshape(K, K, K, cin, cout).permute(4, 3, 0, 1, 2)
    out = F.conv3d(grid, w, padding=(K - 1) // 2 * stride, dilation=stride)
    return out[0].permute(1, 2, 3, 0)[oc[:, 0], oc[:, 1], oc[:, 2]]


def dense_conv_reference(in_coords: np.ndarray, features: np.ndarray,
                         out_coords: np.ndarray, weights: np.ndarray,
                         K: int, stride: int) -> np.ndarray:
    """Dense ground truth: features at ``in_coords`` convolved with the K³
    kernel (offsets ordered like ``offset_grid``), read at
    ``out_coords``; ``[M, cout]`` numpy. ``stride`` is the offset-grid
    stride s_p (the dense kernel's dilation), not the layer stride:
    output coordinates are given explicitly."""
    lo, shape = _grid(in_coords, out_coords, K, stride)
    ic = torch.from_numpy((in_coords - lo).astype(np.int64))
    oc = torch.from_numpy((out_coords - lo).astype(np.int64))
    with torch.no_grad():
        out = _dense_conv(torch.from_numpy(np.ascontiguousarray(features)),
                          torch.from_numpy(np.ascontiguousarray(weights)),
                          ic, oc, shape, K, stride)
    return out.numpy()


def dense_conv_fn(in_coords: np.ndarray, out_coords: np.ndarray, K: int,
                  stride: int):
    """Differentiable dense oracle ``fn(features, weights) -> [M, cout]``
    (torch tensors; autograd gives its gradients): the scatter, conv and
    gather indices are fixed on the host from the coordinate lists. The
    gradient oracle for the engine's transposed-map backward passes."""
    lo, shape = _grid(in_coords, out_coords, K, stride)
    ic_np = (in_coords - lo).astype(np.int64)
    oc_np = (out_coords - lo).astype(np.int64)

    def fn(features: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        dev = features.device
        return _dense_conv(features, weights,
                           torch.from_numpy(ic_np).to(dev),
                           torch.from_numpy(oc_np).to(dev), shape, K, stride)

    return fn
