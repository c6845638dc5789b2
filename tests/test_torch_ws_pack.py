"""The WS kernel's pack and rank, in their plain version
(``kernels.ws_scatter_gemm.ws_pack_torch``), against a brute-force loop
in numpy and against ``core.dataflow.ws_kept_map``: per panel of 128 rows
and offset, the valid rows in row order and their count; the kept prefix
of each list under a capacity is the column's first ``capacity`` valid
rows. Integer-exact; maps made from a seed with numpy, M not a multiple of
the panel. The CUDA pack kernel is held against this plain version on the
card (``tests/test_torch_cuda_kernels.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.dataflow import ws_kept_map
from repro_torch.core.kernel_map import l1_partition
from repro_torch.kernels.ws_scatter_gemm import (PANEL, ws_pack_torch,
                                                 ws_scatter_gemm_torch)

M = 1000          # 7 full panels and a ragged one


def _map(K: int, seed: int = 0) -> np.ndarray:
    """An int32 [M, K^3] map, ~30% valid, the centre column full (as a
    submanifold map's identity offset)."""
    rng = np.random.default_rng(seed + K)
    Kd = K ** 3
    m = rng.integers(0, 5000, size=(M, Kd)).astype(np.int32)
    m[rng.random((M, Kd)) > 0.3] = -1
    m[:, Kd // 2] = np.arange(M)
    return m


def _brute(m: np.ndarray, capacity: int):
    """Lists, counts and kept counts by a loop over panels and offsets."""
    n_p = -(-M // PANEL)
    Ks = m.shape[1]
    rows = [[None] * Ks for _ in range(n_p)]
    count = np.zeros((Ks, n_p), np.int32)
    kept = np.zeros((Ks, n_p), np.int32)
    for k in range(Ks):
        seen = 0                      # valid entries of the column so far
        for p in range(n_p):
            r = [i - p * PANEL for i in range(p * PANEL, min(M, (p + 1) *
                                                             PANEL))
                 if m[i, k] >= 0]
            rows[p][k] = r
            count[k, p] = len(r)
            kept[k, p] = sum(1 for j in range(len(r)) if seen + j < capacity)
            seen += len(r)
    return rows, count, kept


def _capacity(m: np.ndarray, cap: str) -> int:
    top = int((m >= 0).sum(0).max())
    return {"lossless": M, "lossy": top // 2, "zero": 0,
            # a cut inside panel 3 of the sparsest non-empty column
            "midpanel": int((m[:3 * PANEL + PANEL // 2] >= 0).sum(0).min())
            }[cap]


@pytest.mark.parametrize("cap", ["lossless", "lossy", "zero", "midpanel"])
@pytest.mark.parametrize("K", [3, 5])
def test_pack_matches_brute_force_and_kept_map(K, cap):
    m = _map(K)
    c = _capacity(m, cap)
    pk = ws_pack_torch(torch.from_numpy(m), c)
    rows, count, kept = _brute(m, c)
    assert pk.rows.dtype == torch.uint8
    assert pk.count.dtype == pk.kept.dtype == torch.int32
    assert tuple(pk.rows.shape) == (-(-M // PANEL), m.shape[1], PANEL)
    np.testing.assert_array_equal(pk.count.numpy(), count)
    np.testing.assert_array_equal(pk.kept.numpy(), kept)
    got = pk.rows.numpy()
    for p in range(len(rows)):
        for k in range(m.shape[1]):
            np.testing.assert_array_equal(got[p, k, :count[k, p]],
                                          rows[p][k])
    # the kept prefixes are the kept map's pairs
    want = ws_kept_map(torch.from_numpy(m), c) >= 0
    assert torch.equal(pk.kept_mask(M), want)
    if cap == "midpanel":
        part = (pk.kept > 0) & (pk.kept < pk.count)
        assert bool(part.any())
    if cap == "zero":
        assert not pk.kept.any()
        out = ws_scatter_gemm_torch(torch.ones(5000, 2), torch.from_numpy(m),
                                    torch.ones(m.shape[1], 2, 3), capacity=0)
        assert not out.any()


@pytest.mark.parametrize("cap", ["lossless", "lossy"])
def test_pack_reads_a_column_list_in_place(cap):
    """``cols`` (the hybrid dataflow's WS columns) equals packing the
    copied column subset."""
    m = torch.from_numpy(_map(5, seed=3))
    cols = l1_partition(5, 1, 3)[1]
    sub = m[:, torch.as_tensor(cols).long()]
    c = _capacity(sub.numpy(), cap)
    a = ws_pack_torch(m, c, cols=torch.as_tensor(cols, dtype=torch.int32))
    b = ws_pack_torch(sub, c)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
