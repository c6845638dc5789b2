"""Card-only tests: each hand-written CUDA kernel against its plain PyTorch
version on the same CUDA tensors, and the session's batched-equals-single
contract through the kernels. They skip without a card; run them on one
with ``pytest -m cuda tests/test_torch_cuda_kernels.py`` (README).
Imports no JAX, so the card's machine needs only torch, numpy and nvcc.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import packing, voxel, zdelta
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.data import scenes
from repro_torch.kernels import launch_counts, reset_launch_counts, segsum
from repro_torch.kernels.spconv_gather_gemm import (spconv_gather_gemm,
                                                    spconv_gather_gemm_torch)
from repro_torch.kernels.ws_scatter_gemm import (ws_scatter_gemm,
                                                 ws_scatter_gemm_torch)
from repro_torch.kernels.zdelta_window import (zdelta_superwindow_search,
                                               zdelta_window_search)
from repro_torch.core.dataflow import ws_kept_map
from repro_torch.core.kernel_map import l1_partition
from repro_torch.models import pointcloud as pc
from repro_torch.serve import compile_network

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _levels(dev, seed=2, extent=(96, 80, 32)):
    sc = scenes.outdoor_scene(seed, extent=extent)
    p = scenes.pack_scene(sc, capacity=-(-len(sc.coords) // 128) * 128 + 256,
                          device=dev)
    lv = (0, 1, 2)
    return sc.layout, dict(zip(lv, voxel.downsample_all(
        voxel.build_coord_set(p), sc.layout, lv)))


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("m_in,m_out", [(0, 0), (0, 1), (2, 1)])
@pytest.mark.parametrize("W", [256, 2048])
def test_superwindow_kernel_equals_plain(dev, K, m_in, m_out, W):
    layout, cs = _levels(dev)
    _, anchors, zstep = zdelta.zdelta_offsets(K, 1 << min(m_in, m_out),
                                              layout, device=dev)
    W = min(W, cs[m_in].capacity)
    mk, ok = zdelta_superwindow_search(cs[m_in], cs[m_out], anchors, zstep,
                                       K=K, W=W, backend="cuda")
    mp, op = zdelta_superwindow_search(cs[m_in], cs[m_out], anchors, zstep,
                                       K=K, W=W, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(mk, mp)
    assert torch.equal(ok, op)
    if int(ok.sum()) == 0:
        assert torch.equal(mk, zdelta.zdelta_search(cs[m_in], cs[m_out],
                                                    anchors, zstep, K=K))


def test_superwindow_kernel_rejects_int64(dev):
    tl = packing.BitLayout(bx=20, by=20, bz=12)
    p = torch.arange(1024, dtype=torch.int64, device=dev) * 7
    cs = voxel.build_coord_set(p)
    _, anchors, zstep = zdelta.zdelta_offsets(3, 1, tl, device=dev)
    with pytest.raises(NotImplementedError):
        zdelta_superwindow_search(cs, cs, anchors, zstep, K=3, W=512,
                                  backend="cuda")


@pytest.mark.parametrize("cin,cout", [(4, 32), (96, 96), (160, 96),
                                      (256, 128), (17, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_os_kernel_matches_plain(dev, cin, cout, dtype):
    layout, cs = _levels(dev)
    _, anchors, zstep = zdelta.zdelta_offsets(3, 1, layout, device=dev)
    m = zdelta.zdelta_search(cs[0], cs[0], anchors, zstep, K=3)
    g = torch.Generator(device="cpu").manual_seed(cin + cout)
    n = cs[0].capacity
    F = torch.randn((n, cin), generator=g).to(dev, dtype)
    W = (torch.randn((27, cin, cout), generator=g) / (27 * cin) ** 0.5).to(
        dev, dtype)
    got = spconv_gather_gemm(F, m, W)
    ref = spconv_gather_gemm_torch(F, m, W)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (m.shape[0], cout)
    scale = float(ref.float().abs().max())
    tol = 1e-5 * max(1.0, scale) if dtype == torch.float32 else 2e-2 * scale
    assert float((got.float() - ref.float()).abs().max()) <= tol


def test_os_kernel_rows_do_not_depend_on_m(dev):
    """A row's output bits depend only on its own map row."""
    layout, cs = _levels(dev)
    _, anchors, zstep = zdelta.zdelta_offsets(3, 1, layout, device=dev)
    m = zdelta.zdelta_search(cs[0], cs[0], anchors, zstep, K=3)
    F = torch.randn((cs[0].capacity, 48), device=dev)
    W = torch.randn((27, 48, 40), device=dev)
    full = spconv_gather_gemm(F, m, W)
    part = spconv_gather_gemm(F, m[37:1000].contiguous(), W)
    assert torch.equal(full[37:1000], part)


@pytest.mark.parametrize("sizes", [[300], [1, 0, 130], [70000, 33333],
                                   [64, 64, 65]], ids=str)
@pytest.mark.parametrize("q", [8, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segsum_kernel_bitwise(dev, sizes, q, dtype):
    cap = max(1024, 1 << int(np.ceil(np.log2(sum(sizes) + 1))))
    sid, starts, counts = (torch.from_numpy(a).to(dev)
                           for a in segsum.segments_from_sizes(sizes, cap))
    x = torch.randn((cap, 192), device=dev)
    x[::5] *= 1e4
    x[3] = -0.0
    x[sid == len(sizes)] = 0
    x = x.to(dtype)
    got = segsum.segment_sum(x, sid, starts, counts, num_segments=len(sizes),
                             spec=segsum.SegmentSpec(backend="cuda", q=q))
    ref = segsum.segment_sum_torch(x, sid, starts, counts,
                                   num_segments=len(sizes), q=q)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_session_batch_equals_single_on_card(dev):
    batch = scenes.scene_batch(seed=3, batch=2, kind="outdoor",
                               extent=(160, 160, 32), overlap=0.5)
    rng = np.random.default_rng(1)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), 4))
               .astype(np.float32)) for sc in batch]
    net = pc.minkunet42(width=(16, 16, 32, 32))
    s = compile_network(net, batch[0].layout, batch=2, device=dev)
    reset_launch_counts()
    out_b = s(SparseTensor.from_point_clouds(clouds, s.layout, device=dev))
    assert launch_counts() == {"zdelta_superwindow_search": 42,
                               "spconv_gather_gemm": 42, "segment_sum": 42,
                               "ws_scatter_gemm": 0,
                               "zdelta_window_search": 0}
    for i, cloud in enumerate(clouds):
        o1 = s(SparseTensor.from_point_clouds([cloud], s.layout,
                                              device=dev)).unbatch()[0]
        ob = out_b.unbatch()[i]
        n = int(o1.count)
        assert torch.equal(ob.features[:n], o1.features[:n])
    plain = compile_network(pc.minkunet42(width=(16, 16, 32, 32),
                                          backend="torch"),
                            batch[0].layout, batch=2, params=s.params,
                            engine="zdelta", segment_backend="torch",
                            device=dev)
    ref = plain(SparseTensor.from_point_clouds(clouds, s.layout, device=dev))
    n = int(ref.count)
    scale = float(ref.features[:n].abs().max())
    assert float((out_b.features[:n] - ref.features[:n]).abs().max()) <= (
        1e-3 * scale)


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("m_in,m_out", [(0, 0), (0, 1), (2, 1)])
@pytest.mark.parametrize("W", [256, 512])
def test_window_kernel_equals_plain(dev, K, m_in, m_out, W):
    layout, cs = _levels(dev)
    _, anchors, zstep = zdelta.zdelta_offsets(K, 1 << min(m_in, m_out),
                                              layout, device=dev)
    W = min(W, cs[m_in].capacity)
    mk, ok = zdelta_window_search(cs[m_in], cs[m_out], anchors, zstep, K=K,
                                  W=W, backend="cuda")
    mp, op = zdelta_window_search(cs[m_in], cs[m_out], anchors, zstep, K=K,
                                  W=W, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(mk, mp)
    assert torch.equal(ok, op)
    if int(ok.sum()) == 0:
        assert torch.equal(mk, zdelta.zdelta_search(cs[m_in], cs[m_out],
                                                    anchors, zstep, K=K))


def test_window_kernel_rejects_int64(dev):
    tl = packing.BitLayout(bx=20, by=20, bz=12)
    p = torch.arange(1024, dtype=torch.int64, device=dev) * 7
    cs = voxel.build_coord_set(p)
    _, anchors, zstep = zdelta.zdelta_offsets(3, 1, tl, device=dev)
    with pytest.raises(NotImplementedError):
        zdelta_window_search(cs, cs, anchors, zstep, K=3, W=512,
                             backend="cuda")


def _ws_case(dev, K, cols, cin, cout, dtype, seed=0):
    """A K-offset map of an outdoor sweep restricted to ``cols`` ("ws":
    the hybrid t=3 sparse columns, "all"), features and weights."""
    layout, cs = _levels(dev)
    _, anchors, zstep = zdelta.zdelta_offsets(K, 1, layout, device=dev)
    m = zdelta.zdelta_search(cs[0], cs[0], anchors, zstep, K=K)
    if cols == "ws":
        idx = torch.as_tensor(l1_partition(K, 1, 3)[1], device=dev).long()
        m = m[:, idx].contiguous()
    g = torch.Generator(device="cpu").manual_seed(seed + cin + cout)
    F = torch.randn((cs[0].capacity, cin), generator=g).to(dev, dtype)
    W = (torch.randn((m.shape[1], cin, cout), generator=g)
         / (m.shape[1] * cin) ** 0.5).to(dev, dtype)
    return F, m, W


def _assert_ws_close(got, ref, dtype):
    scale = float(ref.abs().max())
    tol = 1e-5 * max(1.0, scale) if dtype == torch.float32 else 2e-2 * scale
    assert float((got - ref).abs().max()) <= tol


@pytest.mark.parametrize("K,cols,cin,cout", [
    (5, "ws", 5, 16), (5, "ws", 16, 16), (3, "all", 16, 32),
    (5, "ws", 32, 32), (3, "all", 32, 64), (5, "ws", 64, 64),
    (3, "all", 17, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lossy", [False, True], ids=["lossless", "lossy"])
def test_ws_kernel_matches_plain(dev, K, cols, cin, cout, dtype, lossy):
    F, m, W = _ws_case(dev, K, cols, cin, cout, dtype)
    top = int((m >= 0).sum(0).max())
    cap = top // 2 if lossy else m.shape[0]
    got = ws_scatter_gemm(F, m, W, capacity=cap)
    ref = ws_scatter_gemm_torch(F, m, W, capacity=cap)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m.shape[0], cout)
    _assert_ws_close(got, ref, dtype)
    if dtype == torch.float32:
        # the dropped pairs are those of the kept map
        os_ref = spconv_gather_gemm_torch(F, ws_kept_map(m, cap), W)
        _assert_ws_close(got, os_ref.float(), dtype)


@pytest.mark.parametrize("bn", [16, 32, 64])
def test_ws_kernel_tiles_and_empty_column(dev, bn):
    F, m, W = _ws_case(dev, 3, "all", 24, 40, torch.float32)
    m = m.clone()
    m[:, 5] = -1
    got = ws_scatter_gemm(F, m, W, capacity=m.shape[0], bn=bn)
    ref = ws_scatter_gemm_torch(F, m, W, capacity=m.shape[0])
    torch.cuda.synchronize()
    _assert_ws_close(got, ref, torch.float32)
    none = ws_scatter_gemm(F, torch.full_like(m, -1), W, capacity=10)
    assert not none.any()


def test_ws_kernel_rows_do_not_depend_on_m(dev):
    """A row's bits depend only on its own map row (lossless capacity)."""
    F, m, W = _ws_case(dev, 5, "ws", 32, 32, torch.float32)
    full = ws_scatter_gemm(F, m, W, capacity=m.shape[0])
    part = ws_scatter_gemm(F, m[37:1000].contiguous(), W, capacity=963)
    assert torch.equal(full[37:1000], part)


def test_ws_kernel_rejects_int64_map(dev):
    F, m, W = _ws_case(dev, 3, "all", 8, 8, torch.float32)
    with pytest.raises(TypeError, match="int32"):
        ws_scatter_gemm(F, m.long(), W, capacity=m.shape[0])


def test_centerpoint_session_on_card(dev):
    """CenterPoint-Large (hybrid, t = 3) through the kernels: every kernel
    of the path launches once per layer, batch of 2 bitwise equal to
    single runs, and the plain path within 1e-3 * max|logits|."""
    batch = scenes.scene_batch(seed=3, batch=2, kind="outdoor",
                               extent=(160, 160, 32), overlap=0.5)
    rng = np.random.default_rng(1)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), 5))
               .astype(np.float32)) for sc in batch]
    net = pc.centerpoint_large(width=(16, 16, 32, 32))
    s = compile_network(net, batch[0].layout, batch=2, device=dev)
    reset_launch_counts()
    out_b = s(SparseTensor.from_point_clouds(clouds, s.layout, device=dev))
    counts = launch_counts()
    assert counts == {"zdelta_superwindow_search": 20,
                      "spconv_gather_gemm": 17, "segment_sum": 20,
                      "ws_scatter_gemm": 20, "zdelta_window_search": 0}
    for i, cloud in enumerate(clouds):
        o1 = s(SparseTensor.from_point_clouds([cloud], s.layout,
                                              device=dev)).unbatch()[0]
        ob = out_b.unbatch()[i]
        n = int(o1.count)
        assert torch.equal(ob.features[:n], o1.features[:n])
    plain = compile_network(pc.centerpoint_large(width=(16, 16, 32, 32),
                                                 backend="torch"),
                            batch[0].layout, batch=2, params=s.params,
                            engine="zdelta", segment_backend="torch",
                            device=dev)
    ref = plain(SparseTensor.from_point_clouds(clouds, s.layout, device=dev))
    n = int(ref.count)
    scale = float(ref.features[:n].abs().max())
    assert float((out_b.features[:n] - ref.features[:n]).abs().max()) <= (
        1e-3 * scale)
