"""Card-only tests: each hand-written CUDA kernel against its plain PyTorch
version on the same CUDA tensors, and the session's batched-equals-single
contract through the kernels. They skip without a card; run them on one
with ``pytest -m cuda tests/test_torch_cuda_kernels.py`` (README).
Imports no JAX, so the card's machine needs only torch, numpy and nvcc.
Training: the masked grouped GEMM and dW kernels against their plain
versions (fp32 dW also against float64, across panel boundaries), the
segment sum over a capacity-long segment and over empty segments, neither
wrapper syncing, OS and WS dF over transposed maps, WS at MinkUNet widths,
and a ``compile_train`` step through the kernels against the plain path.
LM serving: the flash attention kernel against its plain version (head
dims 64/128/256, fp32/bf16, ragged, cross-length, GQA, strided inputs),
and a small dense LM's prefill, decode and slot engine on the card.
Tuner and baselines: measure-mode tuning times and picks the kernels
only, a window above the search kernels' largest is held to it (int32
and int64 words) with exact maps, and the hash, bsearch and sequential
plans equal the superwindow engine's, build after build.
The guarded trainer: NaN and ±Inf features make the gradient norm
non-finite through the kernels, a refused step is bitwise a no-op, a
bisected commit equals the plain trainer on the same scene, and the
guarded update syncs no more than the plain one.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import dataflow, packing, voxel, zdelta
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.data import scenes
from repro_torch.kernels import (launch_counts, ops, reset_launch_counts,
                                 segsum)
from repro_torch.kernels.dw_gather_gemm import (dw_gather_gemm,
                                                dw_gather_gemm_torch)
from repro_torch.kernels.masked_group_gemm import (masked_group_gemm,
                                                   masked_group_gemm_torch)
from repro_torch.kernels.spconv_gather_gemm import (spconv_gather_gemm,
                                                    spconv_gather_gemm_torch)
from repro_torch.kernels.ws_scatter_gemm import (ws_pack_cuda, ws_pack_torch,
                                                 ws_scatter_gemm,
                                                 ws_scatter_gemm_torch)
from repro_torch.kernels.zdelta_window import (zdelta_superwindow_search,
                                               zdelta_window_search)
from repro_torch.core.dataflow import ws_kept_map
from repro_torch.core.kernel_map import l1_partition, transpose_kernel_map
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


# (K, half-search): G = 5 (the K = 3 half-search), 9 (K = 3), 25 (K = 5)
SEARCHES = {"G5": (3, True), "G9": (3, False), "G25": (5, False)}


def _words(dev, dtype, seed=2, extent=(96, 80, 32)):
    """Coordinate sets of levels 0-2 of an outdoor sweep in int32 words (its
    own layout) or int64 words (a 52-bit layout of the same coordinates),
    with two all-PAD output tiles past the last real row."""
    sc = scenes.outdoor_scene(seed, extent=extent)
    layout = sc.layout if dtype == torch.int32 else packing.BitLayout(
        bx=20, by=20, bz=12, guard=sc.layout.guard)
    p = packing.pack(torch.from_numpy(sc.coords).to(dev), layout)
    assert p.dtype == dtype
    words = torch.full((-(-p.shape[0] // 128) * 128 + 256,),
                       voxel.pad_value(dtype), dtype=dtype, device=dev)
    words[: p.shape[0]] = p
    lv = (0, 1, 2)
    return layout, dict(zip(lv, voxel.downsample_all(
        voxel.build_coord_set(words), layout, lv)))


def _anchors(layout, search, m_in, m_out, dev):
    K, half = SEARCHES[search]
    _, anchors, zstep = zdelta.zdelta_offsets(K, 1 << min(m_in, m_out),
                                              layout, device=dev)
    if half:
        anchors = anchors[: zdelta.symmetry_anchor_count(K)]
    return K, anchors, zstep


def _assert_search_equal(search_fn, inputs, outputs, anchors, zstep, K, W):
    mk, ok = search_fn(inputs, outputs, anchors, zstep, K=K, W=W,
                       backend="cuda")
    mp, op = search_fn(inputs, outputs, anchors, zstep, K=K, W=W,
                       backend="torch")
    torch.cuda.synchronize()
    assert mk.dtype == ok.dtype == torch.int32
    assert torch.equal(mk, mp)
    assert torch.equal(ok, op)
    pad = outputs.packed == voxel.pad_value(outputs.packed.dtype)
    assert bool((mk[pad] == -1).all())
    return mk, ok


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("search", list(SEARCHES))
@pytest.mark.parametrize("m_in,m_out", [(0, 0), (0, 1), (2, 1)])
@pytest.mark.parametrize("W", [256, 2048, "N"])
def test_superwindow_kernel_sweep(dev, dtype, search, m_in, m_out, W):
    """Both word types, G = 5/9/25, windows of 256 and 2048 words (clamped
    at the array's end on the coarse levels) and the whole array (base 0):
    maps and counters equal to the plain version, PAD rows -1; the level
    sets hold all-PAD tiles and one partly PAD tile each."""
    layout, cs = _words(dev, dtype)
    K, anchors, zstep = _anchors(layout, search, m_in, m_out, dev)
    n = cs[m_in].capacity
    W = n if W == "N" else min(W, n)
    _, ok = _assert_search_equal(zdelta_superwindow_search, cs[m_in],
                                 cs[m_out], anchors, zstep, K, W)
    if W == n:
        assert int(ok.sum()) == 0


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("search", ["G9", "G25"])
def test_superwindow_kernel_all_pad_outputs(dev, dtype, search):
    """Outputs that are all PAD: the kernel stages nothing, the map is -1
    everywhere and the counters 0, as in the plain version."""
    layout, cs = _words(dev, dtype)
    K, anchors, zstep = _anchors(layout, search, 0, 0, dev)
    empty = voxel.CoordSet(packed=torch.full_like(cs[1].packed,
                                                  voxel.pad_value(dtype)),
                           count=torch.zeros_like(cs[1].count))
    mk, ok = _assert_search_equal(zdelta_superwindow_search, cs[0], empty,
                                  anchors, zstep, K, 2048)
    assert bool((mk == -1).all()) and int(ok.abs().sum()) == 0


def test_superwindow_kernel_int64_equals_int32(dev):
    """The same coordinates in int32 and in int64 words: packed order is
    the same, so the int64 kernel's maps and counters equal the int32
    kernel's."""
    out = []
    for dtype in (torch.int32, torch.int64):
        layout, cs = _words(dev, dtype)
        K, anchors, zstep = _anchors(layout, "G25", 0, 1, dev)
        out.append(zdelta_superwindow_search(cs[0], cs[1], anchors, zstep,
                                             K=K, W=2048, backend="cuda"))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def _os_map(dev, Kd):
    """A kernel map with Kd columns at L0 of the outdoor scene: K = 3 (27)
    or K = 5 (125) searches, or the first 7 columns of the K = 3 map (the
    hybrid dataflow's OS column subsets)."""
    layout, cs = _levels(dev)
    K = 5 if Kd == 125 else 3
    _, anchors, zstep = zdelta.zdelta_offsets(K, 1, layout, device=dev)
    m = zdelta.zdelta_search(cs[0], cs[0], anchors, zstep, K=K)
    return cs[0].capacity, m[:, :Kd].contiguous()


def _os_operands(dev, n, Kd, cin, cout, dtype):
    g = torch.Generator(device="cpu").manual_seed(cin + cout + Kd)
    F = torch.randn((n, cin), generator=g).to(dev, dtype)
    W = (torch.randn((Kd, cin, cout), generator=g) / (Kd * cin) ** 0.5).to(
        dev, dtype)
    return F, W


def _os_close(got, ref, dtype):
    """fp32 within 1e-5 * max(1, max|ref|), bf16 within 2e-2 relative."""
    assert got.dtype == dtype and got.shape == ref.shape
    scale = float(ref.float().abs().max())
    tol = 1e-5 * max(1.0, scale) if dtype == torch.float32 else 2e-2 * scale
    assert float((got.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("Kd", [7, 27, 125])
@pytest.mark.parametrize("cout", [20, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("cin", [4, 5, 17, 96, 160, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_os_kernel_matches_plain(dev, cin, cout, dtype, Kd):
    n, m = _os_map(dev, Kd)
    F, W = _os_operands(dev, n, Kd, cin, cout, dtype)
    got = spconv_gather_gemm(F, m, W)
    ref = spconv_gather_gemm_torch(F, m, W)
    torch.cuda.synchronize()
    _os_close(got, ref, dtype)


@pytest.mark.parametrize("cin,cout", [(17, 20), (96, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_os_kernel_ragged_rows_and_pad_tiles(dev, cin, cout, dtype):
    """M not a multiple of 128, and a whole 128-row tile of PAD rows (every
    offset skipped): the plain version's result, exact zeros on the PAD
    rows."""
    n, m = _os_map(dev, 27)
    m = m[:1165].clone()
    m[256:384] = -1
    F, W = _os_operands(dev, n, 27, cin, cout, dtype)
    got = spconv_gather_gemm(F, m, W)
    ref = spconv_gather_gemm_torch(F, m, W)
    torch.cuda.synchronize()
    _os_close(got, ref, dtype)
    assert not bool(got[256:384].any())


@pytest.mark.parametrize("shift", [37, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_os_kernel_rows_do_not_depend_on_m(dev, shift, dtype):
    """A row's output bits depend only on its own map row: the rows of a
    map shifted by ``shift`` (so they sit elsewhere in their 128-row
    tiles, beside other rows) equal the unshifted run bitwise."""
    n, m = _os_map(dev, 27)
    F, W = _os_operands(dev, n, 27, 48, 40, dtype)
    full = spconv_gather_gemm(F, m, W)
    part = spconv_gather_gemm(F, m[shift:shift + 963].contiguous(), W)
    assert torch.equal(full[shift:shift + 963], part)


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
    # eager: every launch goes through its wrapper's count
    s = compile_network(net, batch[0].layout, batch=2, device=dev,
                        cuda_graphs=False)
    reset_launch_counts()
    out_b = s(SparseTensor.from_point_clouds(clouds, s.layout, device=dev))
    assert launch_counts() == {"zdelta_superwindow_search": 42,
                               "spconv_gather_gemm": 42, "segment_sum": 42,
                               "ws_scatter_gemm": 0,
                               "zdelta_window_search": 0,
                               "masked_group_gemm": 0, "dw_gather_gemm": 0,
                               "flash_attention": 0,
                               "flash_attention_bwd": 0, "zdelta_repair": 42}
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
                            device=dev, cuda_graphs=False)
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


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("search", list(SEARCHES))
@pytest.mark.parametrize("m_in,m_out", [(0, 0), (0, 1), (2, 1)])
@pytest.mark.parametrize("W", [256, 512, 2048, "N"])
def test_window_kernel_sweep(dev, dtype, search, m_in, m_out, W):
    """The per-group window kernel over both word types, G = 5/9/25 and
    windows of 256, 512 (the plan's, an unrolled search), 2048 and all
    words (one window per staged span where windows are wide): maps and
    counters equal to the plain version, PAD rows -1."""
    layout, cs = _words(dev, dtype)
    K, anchors, zstep = _anchors(layout, search, m_in, m_out, dev)
    n = cs[m_in].capacity
    W = n if W == "N" else min(W, n)
    _, ok = _assert_search_equal(zdelta_window_search, cs[m_in], cs[m_out],
                                 anchors, zstep, K, W)
    if W == n:
        assert int(ok.sum()) == 0


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_window_kernel_all_pad_outputs(dev, dtype):
    layout, cs = _words(dev, dtype)
    K, anchors, zstep = _anchors(layout, "G25", 0, 0, dev)
    empty = voxel.CoordSet(packed=torch.full_like(cs[1].packed,
                                                  voxel.pad_value(dtype)),
                           count=torch.zeros_like(cs[1].count))
    mk, ok = _assert_search_equal(zdelta_window_search, cs[0], empty,
                                  anchors, zstep, K, 512)
    assert bool((mk == -1).all()) and int(ok.abs().sum()) == 0


def test_search_wrappers_do_not_sync(dev):
    """Neither search wrapper (phase A included) waits on the card, for
    int32 or int64 words: both run under the sync debug mode "error"."""
    cases = []
    for dtype in (torch.int32, torch.int64):
        layout, cs = _words(dev, dtype)
        K, anchors, zstep = _anchors(layout, "G25", 0, 1, dev)
        cases.append((cs[0], cs[1], anchors, zstep, K))
    for inputs, outputs, anchors, zstep, K in cases:   # builds the library
        zdelta_superwindow_search(inputs, outputs, anchors, zstep, K=K,
                                  W=2048, backend="cuda")
        zdelta_window_search(inputs, outputs, anchors, zstep, K=K, W=512,
                             backend="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = []
        for inputs, outputs, anchors, zstep, K in cases:
            outs += [zdelta_superwindow_search(inputs, outputs, anchors,
                                               zstep, K=K, W=2048,
                                               backend="cuda"),
                     zdelta_window_search(inputs, outputs, anchors, zstep,
                                          K=K, W=512, backend="cuda")]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool((m >= -1).all()) and bool((o >= 0).all())
               for m, o in outs)


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


@pytest.mark.parametrize("cap", ["lossless", "lossy", "zero"])
@pytest.mark.parametrize("K,cols", [(3, "all"), (5, "all"), (5, "ws")])
def test_ws_pack_kernel_equals_plain(dev, K, cols, cap):
    """The pack (and rank) kernels' lists, counts and kept prefixes equal
    ``ws_pack_torch``'s; with ``cols`` the map is read in place."""
    layout, cs = _levels(dev)
    _, anchors, zstep = zdelta.zdelta_offsets(K, 1, layout, device=dev)
    m = zdelta.zdelta_search(cs[0], cs[0], anchors, zstep, K=K)
    idx = (torch.as_tensor(l1_partition(K, 1, 3)[1], dtype=torch.int32,
                           device=dev) if cols == "ws" else None)
    sub = m if idx is None else m[:, idx.long()]
    top = int((sub >= 0).sum(0).max())
    c = {"lossless": m.shape[0], "lossy": top // 2, "zero": 0}[cap]
    got = ws_pack_cuda(m, c, cols=idx)
    want = ws_pack_torch(m, c, cols=idx)
    torch.cuda.synchronize()
    assert torch.equal(got.count, want.count)
    assert torch.equal(got.kept, want.kept)
    live = (torch.arange(got.rows.shape[-1], device=dev)
            < got.count.t()[..., None])
    assert torch.equal(got.rows[live], want.rows[live])
    assert torch.equal(got.kept_mask(m.shape[0]),
                       ws_kept_map(sub, c) >= 0)


@pytest.mark.parametrize("cap", [1000, 100])
def test_ws_pack_kernel_stages_wide_map_rows_in_passes(dev, cap):
    """Map rows of 240 entries stage 96 rows a pass, so a 128-row panel
    takes two passes, the second cut at the panel's end."""
    g = torch.Generator(device="cpu").manual_seed(5)
    m = torch.randint(-1, 1000, (1000, 240), generator=g, dtype=torch.int32)
    m[torch.rand((1000, 240), generator=g) < 0.6] = -1
    m = m.to(dev)
    idx = torch.arange(3, 240, 6, dtype=torch.int32, device=dev)
    got = ws_pack_cuda(m, cap, cols=idx)
    want = ws_pack_torch(m, cap, cols=idx)
    torch.cuda.synchronize()
    assert torch.equal(got.count, want.count)
    assert torch.equal(got.kept, want.kept)
    live = (torch.arange(got.rows.shape[-1], device=dev)
            < got.count.t()[..., None])
    assert torch.equal(got.rows[live], want.rows[live])


@pytest.mark.parametrize("shift", [1, 127, 128, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ws_kernel_rows_at_panel_boundaries(dev, shift, dtype):
    """Rows that move across a 128-row panel boundary keep their bits
    (lossless), and the cut map matches the plain version."""
    F, m, W = _ws_case(dev, 5, "ws", 32, 32, dtype)
    full = ws_scatter_gemm(F, m, W, capacity=m.shape[0])
    part_m = m[shift:shift + 700].contiguous()
    part = ws_scatter_gemm(F, part_m, W, capacity=700)
    torch.cuda.synchronize()
    assert torch.equal(full[shift:shift + 700], part)
    _assert_ws_close(part, ws_scatter_gemm_torch(F, part_m, W, capacity=700),
                     dtype)


@pytest.mark.parametrize("lossy", [False, True], ids=["lossless", "lossy"])
def test_ws_column_list_equals_copied_subset(dev, lossy):
    """The hybrid WS half reading its columns in place is bitwise equal
    to the kernel over the copied column subset."""
    F, m, W = _ws_case(dev, 5, "all", 16, 32, torch.float32)
    idx = torch.as_tensor(l1_partition(5, 1, 3)[1], dtype=torch.int32,
                          device=dev)
    sub = m[:, idx.long()].contiguous()
    Wk = W[idx.long()].contiguous()
    cap = int((sub >= 0).sum(0).max()) // 2 if lossy else m.shape[0]
    a = ws_scatter_gemm(F, m, Wk, capacity=cap, cols=idx)
    b = ws_scatter_gemm(F, sub, Wk, capacity=cap)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_ws_wrapper_does_not_sync(dev):
    """The WS wrapper (pack, rank, sweep) waits on the card at neither
    capacity, nor with a column list: it runs under the sync debug mode
    "error"."""
    F, m, W = _ws_case(dev, 5, "all", 16, 32, torch.float32)
    idx = torch.as_tensor(l1_partition(5, 1, 3)[1], dtype=torch.int32,
                          device=dev)
    Wk = W[idx.long()].contiguous()
    lossy = int((m >= 0).sum(0).max()) // 2
    ws_scatter_gemm(F, m, W, capacity=lossy)     # builds the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [ws_scatter_gemm(F, m, W, capacity=m.shape[0]),
                ws_scatter_gemm(F, m, W, capacity=lossy),
                ws_scatter_gemm(F, m, Wk, capacity=lossy, cols=idx),
                ws_scatter_gemm(F.bfloat16(), m, W.bfloat16(),
                                capacity=m.shape[0])]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(o).all()) for o in outs)


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
    s = compile_network(net, batch[0].layout, batch=2, device=dev,
                        cuda_graphs=False)
    reset_launch_counts()
    out_b = s(SparseTensor.from_point_clouds(clouds, s.layout, device=dev))
    counts = launch_counts()
    assert counts == {"zdelta_superwindow_search": 20,
                      "spconv_gather_gemm": 17, "segment_sum": 20,
                      "ws_scatter_gemm": 20, "zdelta_window_search": 0,
                      "masked_group_gemm": 0, "dw_gather_gemm": 0,
                      "flash_attention": 0, "flash_attention_bwd": 0,
                      "zdelta_repair": 20}
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
                            device=dev, cuda_graphs=False)
    ref = plain(SparseTensor.from_point_clouds(clouds, s.layout, device=dev))
    n = int(ref.count)
    scale = float(ref.features[:n].abs().max())
    assert float((out_b.features[:n] - ref.features[:n]).abs().max()) <= (
        1e-3 * scale)


# ---------------------------------------------------------------------------
# training: masked grouped GEMM, dW, dF over transposed maps, a train step
# ---------------------------------------------------------------------------

def _map_case(dev, m_in, m_out, cin, cout, dtype, seed=0):
    """A K=3 map of an outdoor sweep (sub, down or up), features, weights
    and an output cotangent."""
    layout, cs = _levels(dev)
    _, anchors, zstep = zdelta.zdelta_offsets(3, 1 << min(m_in, m_out),
                                              layout, device=dev)
    m = zdelta.zdelta_search(cs[m_in], cs[m_out], anchors, zstep, K=3)
    g = torch.Generator(device="cpu").manual_seed(seed + cin + cout)
    F = torch.randn((cs[m_in].capacity, cin), generator=g).to(dev, dtype)
    W = (torch.randn((27, cin, cout), generator=g) / (27 * cin) ** 0.5).to(
        dev, dtype)
    ct = torch.randn((m.shape[0], cout), generator=g).to(dev, dtype)
    return F, m, W, ct


def _close(got, ref, dtype):
    scale = float(ref.float().abs().max())
    tol = 1e-5 * max(1.0, scale) if dtype == torch.float32 else 2e-2 * scale
    assert float((got.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("M,cin,cout", [(1000, 32, 64), (777, 17, 20),
                                        (4096, 96, 96), (130, 4, 32),
                                        (640, 256, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_group_gemm_kernel_matches_plain(dev, M, cin, cout, dtype):
    """Ragged M and Cout, Cin on and off the 16-byte staging path."""
    g = torch.Generator(device="cpu").manual_seed(M + cin)
    m = torch.randint(-1, M, (M, 27), generator=g, dtype=torch.int32).to(dev)
    gathered = torch.randn((M, 27, cin), generator=g).to(dev, dtype)
    W = (torch.randn((27, cin, cout), generator=g) / (27 * cin) ** 0.5).to(
        dev, dtype)
    got = masked_group_gemm(m, gathered, W)
    ref = masked_group_gemm_torch(m, gathered, W)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, cout)
    _close(got, ref, dtype)


def test_masked_group_gemm_kernel_masks_by_multiply(dev):
    m = torch.tensor([[0, -1], [1, 1]], dtype=torch.int32, device=dev)
    gathered = torch.ones((2, 2, 16), device=dev)
    gathered[0, 1, 3] = float("inf")
    W = torch.ones((2, 16, 8), device=dev)
    got = masked_group_gemm(m, gathered, W)
    assert torch.isnan(got[0]).all()
    assert torch.equal(got[1], torch.full((8,), 32.0, device=dev))


@pytest.mark.parametrize("Kd,cin,cout", [(27, 96, 96), (27, 4, 32),
                                          (27, 17, 20), (125, 32, 256)])
def test_masked_group_gemm_kernel_float64_gate(dev, Kd, cin, cout):
    """fp32 (3xTF32) against the same contraction in float64: the kernel's
    max|error| within max(4 x the plain fp32 version's, 1e-6 max|ref|)."""
    M = 1000
    g = torch.Generator(device="cpu").manual_seed(Kd + cin + cout)
    m = torch.randint(-1, M, (M, Kd), generator=g, dtype=torch.int32).to(dev)
    gathered = torch.randn((M, Kd, cin), generator=g).to(dev)
    W = (torch.randn((Kd, cin, cout), generator=g) / (Kd * cin) ** 0.5).to(
        dev)
    got = masked_group_gemm(m, gathered, W)
    ref = masked_group_gemm_torch(m, gathered, W)
    pre = gathered.double() * (m >= 0)[..., None]
    ref64 = torch.einsum("mkc,kcd->md", pre, W.double())
    e_k = float((got.double() - ref64).abs().max())
    e_p = float((ref.double() - ref64).abs().max())
    assert e_k <= max(4 * e_p, 1e-6 * float(ref64.abs().max()))


@pytest.mark.parametrize("cin", [17, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_group_gemm_kernel_unaligned_rows(dev, cin, dtype):
    """Rows of g whose pitch (27 Cin elements) is not 16-byte aligned (8-
    and 4-byte copies; 2-byte loads for odd bf16 pitches), and a g that
    starts off a 16-byte boundary."""
    M = 300
    g = torch.Generator(device="cpu").manual_seed(cin)
    m = torch.randint(-1, M, (M, 27), generator=g, dtype=torch.int32).to(dev)
    base = torch.randn((M * 27 * cin + 1,), generator=g).to(dev, dtype)
    gathered = base[1:].view(M, 27, cin)
    W = (torch.randn((27, cin, 48), generator=g) / (27 * cin) ** 0.5).to(
        dev, dtype)
    got = masked_group_gemm(m, gathered, W)
    torch.cuda.synchronize()
    _close(got, masked_group_gemm_torch(m, gathered, W), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_group_gemm_kernel_nan_in_a_masked_fragment(dev, dtype):
    """An offset that no row of a 16-row fragment uses is skipped only
    where its values are finite: an inf there still makes its row NaN,
    and only that row."""
    M = 40
    m = torch.zeros((M, 3), dtype=torch.int32, device=dev)
    m[:, 1] = -1
    gathered = torch.ones((M, 3, 16), device=dev, dtype=dtype)
    gathered[5, 1, 7] = float("inf")
    W = torch.ones((3, 16, 8), device=dev, dtype=dtype)
    got = masked_group_gemm(m, gathered, W)
    torch.cuda.synchronize()
    assert torch.isnan(got[5]).all()
    rest = torch.cat([got[:5], got[6:]]).float()
    assert torch.equal(rest, torch.full_like(rest, 32.0))


def test_output_stationary_fused_on_card(dev):
    F, m, W, _ = _map_case(dev, 0, 0, 32, 48, torch.float32)
    got = ops.output_stationary_fused(F, m, W)
    _close(got, ops.spconv_os_fused(F, m, W), torch.float32)
    _close(got, ops.output_stationary_fused(F, m, W, backend="torch"),
           torch.float32)


@pytest.mark.parametrize("m_in,m_out,cin,cout", [(0, 0, 32, 32),
                                                 (0, 1, 17, 70),
                                                 (1, 0, 96, 96),
                                                 (0, 0, 4, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_kernel_matches_plain(dev, m_in, m_out, cin, cout, dtype):
    F, m, _, ct = _map_case(dev, m_in, m_out, cin, cout, dtype)
    got = dw_gather_gemm(F, m, ct)
    ref = dw_gather_gemm_torch(F, m, ct)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (27, cin, cout)
    _close(got, ref, dtype)


def test_dw_kernel_is_zero_extension_invariant(dev):
    """Rows appended with m = -1 and any cotangent change no bit of dW; the
    head's identity map likewise with zero rows."""
    F, m, _, ct = _map_case(dev, 0, 0, 48, 40, torch.float32)
    a = dw_gather_gemm(F, m, ct)
    M = m.shape[0]
    m2 = torch.cat([m, torch.full((3 * M + 77, 27), -1, dtype=torch.int32,
                                  device=dev)])
    ct2 = torch.cat([ct, torch.randn((3 * M + 77, 40), device=dev)])
    assert torch.equal(dw_gather_gemm(F, m2, ct2), a)
    rows = torch.arange(M, dtype=torch.int32, device=dev)[:, None]
    x = torch.randn((M, 24), device=dev)
    h = dw_gather_gemm(x, rows, ct)
    rows2 = torch.arange(2 * M, dtype=torch.int32, device=dev)[:, None]
    x2 = torch.cat([x, torch.zeros_like(x)])
    assert torch.equal(dw_gather_gemm(x2, rows2, torch.cat([ct, ct])), h)



def _dw_f64(F, m, ct):
    """The per-offset weight gradient in float64: the yardstick of the
    kernel's and the plain version's fp32 rounding."""
    out = []
    for k in range(m.shape[1]):
        col = m[:, k]
        gk = F.double()[col.clamp(min=0).long()] * (col >= 0)[:, None]
        out.append(gk.t() @ ct.double())
    return torch.stack(out)


def _dw_gate(got, ref, ref64):
    """fp32: the kernel (3xTF32) within max(4x the plain fp32 version's
    max|error| against float64, 1e-6 max|ref|), and within 1e-4 max|ref|
    of the plain version."""
    e_k = float((got.double() - ref64).abs().max())
    e_p = float((ref.double() - ref64).abs().max())
    scale = float(ref64.abs().max())
    assert e_k <= max(4.0 * e_p, 1e-6 * scale)
    assert float((got - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("m_in,m_out,cin,cout", [(0, 0, 4, 32),
                                                 (0, 1, 17, 70),
                                                 (1, 0, 96, 96),
                                                 (1, 1, 256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_kernel_float64_gate(dev, m_in, m_out, cin, cout, dtype):
    """The stem, a ragged layer, one 96 x 96 tile, 64 x 64 tiles of a
    256 x 256 layer: fp32 held against float64, bf16 against the plain
    version."""
    F, m, _, ct = _map_case(dev, m_in, m_out, cin, cout, dtype)
    got = dw_gather_gemm(F, m, ct)
    ref = dw_gather_gemm_torch(F, m, ct)
    torch.cuda.synchronize()
    assert got.shape == (27, cin, cout)
    if dtype == torch.float32:
        _dw_gate(got, ref, _dw_f64(F, m, ct))
    else:
        _close(got, ref, dtype)


def _panel_map(dev, seed=0):
    """A map over 3 panels and 77 rows: offset 0 random, 1 valid only on
    rows that straddle the first panel boundary, 2 without a valid row in
    panel 1, 3 never valid, 4 valid on every row."""
    from repro_torch.kernels.dw_gather_gemm import PANEL
    M, N = 3 * PANEL + 77, 5000
    g = torch.Generator(device="cpu").manual_seed(seed)
    m = torch.randint(0, N, (M, 5), generator=g, dtype=torch.int32)
    drop = torch.rand((M, 5), generator=g) < 0.7
    m[:, 0][drop[:, 0]] = -1
    m[:, 1] = -1
    m[PANEL - 6:PANEL + 6, 1] = torch.arange(12, dtype=torch.int32)
    m[:, 2][drop[:, 2]] = -1
    m[PANEL:2 * PANEL, 2] = -1
    m[:, 3] = -1
    return m.to(dev), N, M


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_kernel_panels(dev, dtype):
    """Valid rows across panel boundaries, a panel without rows for an
    offset, an offset without rows: equal to the plain version (fp32 under
    the float64 gate), and exact zeros where no row is valid."""
    m, N, M = _panel_map(dev)
    g = torch.Generator(device="cpu").manual_seed(1)
    F = torch.randn((N, 48), generator=g).to(dev, dtype)
    ct = torch.randn((M, 40), generator=g).to(dev, dtype)
    got = dw_gather_gemm(F, m, ct)
    ref = dw_gather_gemm_torch(F, m, ct)
    torch.cuda.synchronize()
    assert torch.equal(got[3], torch.zeros_like(got[3]))
    if dtype == torch.float32:
        _dw_gate(got, ref, _dw_f64(F, m, ct))
    else:
        _close(got, ref, dtype)


def _long_segment(dev, C, dtype, cap=262144, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed + C)
    x = torch.randn((cap, C), generator=g)
    x[::5] *= 1e4
    x[3] = -0.0
    i32 = torch.int32
    return (x.to(dev, dtype), torch.zeros(cap, dtype=i32, device=dev),
            torch.zeros(1, dtype=i32, device=dev),
            torch.full((1,), cap, dtype=i32, device=dev))


@pytest.mark.parametrize("C", [1, 20, 33, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segsum_kernel_capacity_long_segment(dev, C, dtype):
    """One segment over the whole 262,144-row capacity (the bias
    gradient's 4,096-chunk chain), bitwise."""
    x, sid, starts, counts = _long_segment(dev, C, dtype)
    got = segsum.segment_sum_cuda(x, sid, starts, counts, num_segments=1)
    ref = segsum.segment_sum_torch(x, sid, starts, counts, num_segments=1)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("C", [1, 20, 33, 512])
@pytest.mark.parametrize("q", [8, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segsum_kernel_sixteen_segments_with_empties(dev, C, q, dtype):
    sizes = [0, 5, 0, 0, 300, 1, 0, 64, 65, 0, 129, 7, 0, 0, 4096, 3]
    cap = 8192
    sid, starts, counts = (torch.from_numpy(a).to(dev)
                           for a in segsum.segments_from_sizes(sizes, cap))
    g = torch.Generator(device="cpu").manual_seed(C + q)
    x = torch.randn((cap, C), generator=g).to(dev)
    x[::7] *= 1e4
    x[sid == len(sizes)] = 0
    x = x.to(dtype)
    got = segsum.segment_sum_cuda(x, sid, starts, counts,
                                  num_segments=len(sizes), q=q)
    ref = segsum.segment_sum_torch(x, sid, starts, counts,
                                   num_segments=len(sizes), q=q)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    empty = torch.tensor([c == 0 for c in sizes], device=dev)
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))


def test_dw_and_segsum_wrappers_do_not_sync(dev):
    """Neither wrapper waits on the card (the path stays capturable in a
    CUDA graph): both run under the sync debug mode "error"."""
    F, m, _, ct = _map_case(dev, 0, 0, 32, 48, torch.float32)
    x, sid, starts, counts = _long_segment(dev, 20, torch.float32,
                                           cap=16384)
    dw_gather_gemm(F, m, ct)                  # first use builds the library
    segsum.segment_sum_cuda(x, sid, starts, counts, num_segments=1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = dw_gather_gemm(F, m, ct)
        b = segsum.segment_sum_cuda(x, sid, starts, counts, num_segments=1)
        c = segsum.segment_sum_cuda(x.to(torch.bfloat16), sid, starts,
                                    counts, num_segments=1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(a).all() & torch.isfinite(b).all()
                & torch.isfinite(c).all())


def _layer_grads(flow, F, m, W, ct, backend, cap=None):
    f = F.clone().requires_grad_()
    w = W.clone().requires_grad_()
    if flow == "os":
        out = dataflow.output_stationary(f, m, w, backend=backend)
    else:
        out = dataflow.weight_stationary(f, m, w, capacity=cap,
                                         backend=backend)
    return torch.autograd.grad((out.float() * ct.float()).sum(), (f, w))


@pytest.mark.parametrize("m_in,m_out", [(0, 0), (0, 1), (1, 0)])
@pytest.mark.parametrize("flow", ["os", "ws"])
def test_df_over_transposed_map_matches_plain(dev, flow, m_in, m_out):
    """dF (the forward kernel over the transposed map) and dW through the
    kernels against the plain path, lossless and lossy WS."""
    F, m, W, ct = _map_case(dev, m_in, m_out, 32, 48, torch.float32)
    caps = ([None] if flow == "os"
            else [m.shape[0], int((m >= 0).sum(0).max()) // 2])
    for cap in caps:
        reset_launch_counts()
        gk = _layer_grads(flow, F, m, W, ct, "cuda", cap)
        n = launch_counts()
        kern = "spconv_gather_gemm" if flow == "os" else "ws_scatter_gemm"
        assert n[kern] == 2 and n["dw_gather_gemm"] == 1
        gp = _layer_grads(flow, F, m, W, ct, "torch", cap)
        for a, b in zip(gk, gp):
            _close(a, b, torch.float32)
    mt = transpose_kernel_map(m, n_in=F.shape[0])
    if m_in == m_out:
        assert torch.equal(mt, m)


@pytest.mark.parametrize("cout", [96, 128, 256])
def test_ws_kernel_at_minkunet_widths(dev, cout):
    """Cout beyond the 64-wide tile is tiled, not cut."""
    F, m, W, _ = _map_case(dev, 0, 0, 96, cout, torch.float32)
    for cap in (m.shape[0], int((m >= 0).sum(0).max()) // 2):
        got = ws_scatter_gemm(F, m, W, capacity=cap)
        ref = ws_scatter_gemm_torch(F, m, W, capacity=cap)
        torch.cuda.synchronize()
        _close(got, ref, torch.float32)


def _rel_l2(a: dict, b: dict) -> float:
    """‖a − b‖₂ / ‖b‖₂ over all tensors of two gradient dictionaries."""
    num = sum(float(((a[k] - b[k]).double() ** 2).sum()) for k in b)
    den = sum(float((b[k].double() ** 2).sum()) for k in b)
    return (num / den) ** 0.5


def test_compile_train_step_on_card(dev):
    """A MinkUNet step through the kernels: every kernel of the path
    launches, the backward adds no search, and the gradients agree with
    the plain path (engine "zdelta", backends "torch") on the same card.
    Deep BN nets at random init have ill-conditioned gradients, so the
    agreement is calibrated: the kernel path is no farther from the plain
    path (relative L2 over all parameters) than the kernel path is from
    itself when the weights move by 1e-6 relative."""
    from repro_torch.train import labeled_batch
    from repro_torch.train.pointcloud import make_segmentation_loss_fn
    batch = scenes.scene_batch(seed=3, batch=2, kind="outdoor",
                               extent=(160, 160, 32), overlap=0.5,
                               labels=True, n_classes=8)
    net = pc.minkunet42(width=(16, 16, 32, 32), n_classes=8)
    s = compile_network(net, batch[0].layout, batch=2, device=dev)
    st, lab = labeled_batch(batch, s.layout, device=dev)
    trainer = s.compile_train()
    zdelta.reset_search_calls()
    reset_launch_counts()
    m = trainer.step(st, lab)
    counts = launch_counts()
    assert np.isfinite(m["loss"]) and zdelta.search_call_count() == 42
    assert counts["zdelta_superwindow_search"] == 42
    # forward 42 + dF of every layer but the stem's (its input needs none)
    assert counts["spconv_gather_gemm"] == 42 + 41
    # 42 conv layers and the head
    assert counts["dw_gather_gemm"] == 43
    # BN forward + its gather's backward per layer, bias grads, the loss
    assert counts["segment_sum"] == 42 + 42 + 42 + 1
    out = s(st)
    assert bool(torch.isfinite(out.features[:int(out.count)]).all())

    plain_net = pc.minkunet42(width=(16, 16, 32, 32), n_classes=8,
                              backend="torch")
    stp = st.pad_to(s._bucket(st.capacity))
    labp = torch.cat([lab, torch.full((stp.capacity - lab.shape[0],), -1,
                                      dtype=torch.int32, device=dev)])

    def grads(net_, engine, seg_backend, model):
        fn = make_segmentation_loss_fn(
            net_, s.layout, engine=engine,
            segment=segsum.SegmentSpec(backend=seg_backend))
        named = dict(model.named_parameters())
        loss, _ = fn(model, stp.packed, stp.features, labp)
        return dict(zip(named, torch.autograd.grad(loss,
                                                   list(named.values()))))

    gk = grads(net, "zdelta_cuda", "auto", s.params)
    gp = grads(plain_net, "zdelta", "torch", s.params)
    pert = pc.init_pointcloud(net, device=dev)
    g = torch.Generator(device="cpu").manual_seed(0)
    with torch.no_grad():
        for p, q in zip(pert.parameters(), s.params.parameters()):
            p.copy_(q * (1 + 1e-6 * torch.randn(q.shape, generator=g)
                         .to(dev)))
    gs = grads(net, "zdelta_cuda", "auto", pert)
    assert _rel_l2(gk, gp) <= max(1e-3, _rel_l2(gs, gk))



# -- flash attention and the LM serving path ---------------------------------

from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_torch)
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.models.common import dense_lm  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402


def _attn_inputs(dev, shape_q, shape_k, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in (shape_q, shape_k, shape_k)]


def _attn_close(got, ref, dtype):
    """fp32 within 1e-5 * max(1, max|ref|); bf16 within 2e-2 relative."""
    d = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    tol = (1e-5 * max(1.0, scale) if dtype == torch.float32
           else 2e-2 * max(scale, 1e-30))
    assert bool(torch.isfinite(got.float()).all())
    assert d <= tol, (d, tol)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Skv,H,KV", [(256, 256, 4, 2), (100, 100, 2, 1),
                                         (37, 300, 4, 4), (130, 61, 2, 2),
                                         (300, 70, 4, 2), (1, 1, 2, 1),
                                         (2000, 2000, 32, 4)])
def test_flash_attention_kernel_matches_plain(dev, D, dtype, causal, Sq, Skv,
                                              H, KV):
    q, k, v = _attn_inputs(dev, (2, Sq, H, D), (2, Skv, KV, D), dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    ref = flash_attention_torch(q, k, v, causal=causal, scale=D ** -0.5)
    _attn_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_reads_strided_views(dev, dtype):
    """q, k and v as head slices of one packed [B, S, H + 2 KV, D] tensor
    (read in place), and a view whose base is not 16-byte aligned (copied
    first): the same result as contiguous copies."""
    B, S, H, KV, D = 2, 150, 8, 2, 128
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn((B, S, H + 2 * KV, D), generator=g,
                      device=dev).to(dtype)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    got = flash_attention(q, k, v, causal=True, scale=1.0)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True, scale=1.0)
    assert torch.equal(got, want)
    flat = torch.randn(B * S * H * D + 1, generator=g, device=dev).to(dtype)
    odd = flat[1:].view(B, S, H, D)
    assert odd.data_ptr() % 16 != 0
    assert torch.equal(flash_attention(odd, k, v, causal=True, scale=1.0),
                       flash_attention(odd.clone(), k, v, causal=True,
                                       scale=1.0))


def test_flash_attention_kernel_rejects_what_it_cannot_run(dev):
    q, k, v = _attn_inputs(dev, (1, 8, 2, 32), (1, 8, 2, 32), torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v, causal=True, scale=1.0)
    q, k, v = _attn_inputs(dev, (1, 8, 2, 64), (1, 8, 2, 64), torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, k, v, causal=True, scale=1.0)


def test_ops_attention_on_card(dev):
    q, k, v = _attn_inputs(dev, (4, 200, 64), (4, 333, 64), torch.float32)
    before = flash_attention.launches
    got = ops.attention(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    ref = ops.attention(q, k, v, causal=True, backend="torch")
    _attn_close(got, ref, torch.float32)


def _tiny_lm(dtype):
    return dense_lm("tiny-card", n_layers=3, d_model=256, n_heads=4, n_kv=2,
                    d_ff=512, vocab=384, head_dim=64, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_prefill_and_decode_on_card(dev, dtype):
    """Prefill through the kernel (one launch per layer) against the plain
    path; the decode step launches nothing and matches the CPU."""
    cfg = _tiny_lm(dtype)
    params = lm.init_params(cfg, 0, device=dev)[0]
    tok = torch.randint(0, cfg.vocab, (1, 77), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
    reset_launch_counts()
    lk, sk = lm.prefill(params, cfg, {"tokens": tok}, 128)
    assert launch_counts()["flash_attention"] == cfg.n_layers
    lp, sp = lm.prefill(params, cfg, {"tokens": tok}, 128, backend="torch")
    assert launch_counts()["flash_attention"] == cfg.n_layers
    rel = 1e-4 if dtype == "float32" else 5e-2
    scale = float(lp.float().abs().max())
    assert float((lk.float() - lp.float()).abs().max()) <= rel * scale
    nxt = lk[:, -1].argmax(-1, keepdim=True)
    dk, _ = lm.decode_step(params, cfg, sk, {"tokens": nxt}, 77)
    assert launch_counts()["flash_attention"] == cfg.n_layers
    dp, _ = lm.decode_step(params, cfg, sp, {"tokens": nxt}, 77)
    assert float((dk.float() - dp.float()).abs().max()) <= rel * float(
        dp.float().abs().max())


def test_lm_serve_engine_on_card(dev):
    """Greedy tokens through the kernel equal the plain path's (fp32), and
    the engine launches the kernel once per layer per request."""
    cfg = _tiny_lm("float32")
    params = lm.init_params(cfg, 0, device=dev)[0]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (7, 70, 12)]
    outs = {}
    for backend in ("auto", "torch"):
        reqs = [Request(prompt=p, max_new=6) for p in prompts]
        reset_launch_counts()
        ServeEngine(cfg, params, batch_slots=2, cache_len=96,
                    backend=backend).run(list(reqs))
        launched = launch_counts()["flash_attention"]
        assert launched == (len(prompts) * cfg.n_layers
                            if backend == "auto" else 0)
        outs[backend] = [r.out for r in reqs]
    assert outs["auto"] == outs["torch"]


# ---------------------------------------------------------------------------
# the tuner and the paper's baselines on the card
# ---------------------------------------------------------------------------

def _scene_clouds(seed=2, extent=(96, 80, 32), channels=5, scenes_n=2):
    batch = scenes.scene_batch(seed=seed, batch=scenes_n, kind="outdoor",
                               extent=extent, overlap=0.5)
    rng = np.random.default_rng(seed)
    return batch[0].layout, [
        (sc.coords, rng.normal(size=(len(sc.coords), channels))
         .astype(np.float32)) for sc in batch]


def test_measure_tuning_on_card_runs_the_kernels(dev):
    """Measure mode on the card times the kernels only: every tuned layer
    and the segment engine on "cuda", and the tuned session serves."""
    layout, clouds = _scene_clouds()
    net = pc.centerpoint_large(width=(8, 8, 8, 8))
    sample = SparseTensor.from_point_clouds(clouds[:1], layout.with_batch(2))
    s = compile_network(net, layout, batch=2, min_bucket=128,
                        tuner="measure", tune_sample=sample)
    assert all(sp.backend == "cuda" for sp in s.net.specs)
    for r in s.tune_report.results.values():
        assert {k[1] for k in r.per_config} == {"cuda"} and r.window > 0
    assert s.segment.backend == "cuda"
    assert set(s.tune_report.segment.per_backend) == {"cuda"}
    out = s(SparseTensor.from_point_clouds(clouds, s.layout))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.features[:int(out.count)]).all())


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
def test_oversized_window_is_limited_and_exact(dev, wide):
    """The largest window ``max_window`` names launches and twice it does
    not; a tuned W above it is held to it, and the session's maps equal
    the exact search's."""
    from repro_torch.core.network_plan import build_network_plan
    from repro_torch.core.tuner import LayerTuneResult
    from repro_torch.kernels.zdelta_window import max_window
    sc = scenes.outdoor_scene(2, extent=(768, 768, 40))
    layout = (packing.BitLayout(bx=12, by=12, bz=7, bb=1, guard=sc.layout.guard)
              if wide else sc.layout.with_batch(2))
    assert layout.dtype == (torch.int64 if wide else torch.int32)
    rng = np.random.default_rng(0)
    st = SparseTensor.from_point_clouds(
        [(sc.coords, rng.normal(size=(len(sc.coords), 4)).astype(np.float32))],
        layout)
    cs = voxel.build_coord_set(st.pad_to(65536).packed)
    for kind, search in (("superwindow", zdelta_superwindow_search),
                         ("window", zdelta_window_search)):
        cap = max_window(kind, layout.dtype, 9, 3)
        assert cap == (16384 if wide else 32768)
        _, anchors, zstep = zdelta.zdelta_offsets(3, 1, layout, device=dev)
        m, ovf = search(cs, cs, anchors, zstep, K=3, W=cap, backend="cuda")
        torch.cuda.synchronize()
        assert int(ovf.sum()) == 0
        assert torch.equal(m, zdelta.zdelta_search(cs, cs, anchors, zstep,
                                                   K=3))
        with pytest.raises(RuntimeError):
            search(cs, cs, anchors, zstep, K=3, W=2 * cap, backend="cuda")
    net = pc.tiny_segnet(in_channels=4, n_classes=5, width=8, depth=2)
    big = LayerTuneResult(t_best=0, backend="cuda", bm=0, bn=0,
                          window=10 ** 6, per_config={}, mode="measure")
    for engine, kind in (("zdelta_cuda", "superwindow"),
                         ("zdelta_cuda_window", "window")):
        s = compile_network(net, layout, engine=engine,
                            tuner={sp.name: big for sp in net.specs})
        cap = max_window(kind, layout.dtype, 9, 3)
        assert s.tune_report.windows_limited == {
            sp.name: (10 ** 6, cap) for sp in net.specs}
        plan = s.plan(st)
        ref = build_network_plan(st.pad_to(plan.coords[0].capacity).packed,
                                 specs=net.specs, layout=layout,
                                 engine="zdelta")
        for sp in net.specs:
            assert torch.equal(plan.kmaps[sp.name].m, ref.kmaps[sp.name].m)
        out = s(st)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out.features[:int(out.count)]).all())


def test_baseline_engines_on_card_equal_zdelta_cuda(dev):
    """The hash engine's maps equal the superwindow engine's on every
    MinkUNet-42 and CenterPoint-Large layer, build after build (its insert
    scatter keeps an arbitrary winner per slot on the card); so do the
    bsearch engine's and the sequential plan's."""
    from repro_torch.core.network_plan import (build_network_plan,
                                               sequential_plan_fns)
    layout, clouds = _scene_clouds(extent=(256, 256, 32))
    st = SparseTensor.from_point_clouds(clouds, layout.with_batch(2))
    p = st.pad_to(-(-st.capacity // 128) * 128).packed
    specs = (pc.minkunet42(width=(8, 8, 8, 8)).specs
             + pc.centerpoint_large(width=(8, 8, 8, 8)).specs)
    ref = build_network_plan(p, specs=specs, layout=st.layout)
    for engine, builds in (("hash", 4), ("bsearch", 1)):
        for _ in range(builds):
            plan = build_network_plan(p, specs=specs, layout=st.layout,
                                      engine=engine)
            for s in specs:
                assert torch.equal(plan.kmaps[s.name].m,
                                   ref.kmaps[s.name].m), (engine, s.name)
    sort_fn, level_fns, map_fns = sequential_plan_fns(specs, st.layout)
    v0 = sort_fn(p)
    coords = {0: v0, **{m: fn(v0) for m, fn in level_fns.items()}}
    for s in specs:
        km = map_fns[s.name](coords[s.m_in], coords[s.m_out])
        assert torch.equal(km.m, ref.kmaps[s.name].m), s.name


# -- the self-healing trainer on the card -------------------------------------

def _guard_case(dev):
    """A narrow MinkUNet-42 session, its labeled batch of 2 and a second
    session with the same weights in separate tensors."""
    from repro_torch.train import labeled_batch
    batch = scenes.scene_batch(seed=3, batch=2, kind="outdoor",
                               extent=(160, 160, 32), overlap=0.5,
                               labels=True, n_classes=8)
    net = pc.minkunet42(width=(16, 16, 32, 32), n_classes=8)
    s = compile_network(net, batch[0].layout, batch=2, device=dev)
    twin = compile_network(net, batch[0].layout, batch=2, device=dev)
    st, lab = labeled_batch(batch, s.layout, device=dev)
    return batch, s, twin, st, lab


def _state(s, tr):
    return ([p.detach().clone() for p in s.params.parameters()]
            + [t.clone() for t in tr.opt_state.mu.values()]
            + [t.clone() for t in tr.opt_state.nu.values()]
            + [tr.opt_state.step])


def _same(a, b):
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf")])
def test_nonfinite_features_make_the_gradient_norm_nonfinite(dev, value):
    """NaN and ±Inf in one scene's features reach the loss or the gradient
    norm through the OS forward and dF, dW and the segment sum (3xTF32
    splits an Inf into hi = Inf, lo = NaN): the guarded update refuses the
    step."""
    from repro_torch.train import faults as tf
    from repro_torch.train import (PointCloudTrainConfig,
                                   guarded_apply_updates, init_opt_state)
    from repro_torch.train.pointcloud import make_grad_fn
    _, s, _, st, lab = _guard_case(dev)
    stp = tf.poison_scene_nonfinite(st, 1, value=value).pad_to(
        s._bucket(st.capacity))
    labp = torch.cat([lab, torch.full((stp.capacity - lab.shape[0],), -1,
                                      dtype=torch.int32, device=dev)])
    grad_fn = make_grad_fn(s.net, s.layout)
    reset_launch_counts()
    named, grads, loss, _ = grad_fn(s.params, stp.packed, stp.features, labp)
    n = launch_counts()
    assert n["spconv_gather_gemm"] == 83 and n["dw_gather_gemm"] == 43
    assert n["segment_sum"] == 127
    cfg = PointCloudTrainConfig().opt
    _, m = guarded_apply_updates(named, grads, init_opt_state(named, cfg),
                                 cfg, loss=loss)
    assert not bool(m["step_ok"])
    assert not bool(torch.isfinite(m["grad_norm"]))


def test_guarded_noop_on_card_is_bitwise(dev):
    """A refused step (both scenes NaN) leaves params, moments and step
    bitwise as they were, through the kernels."""
    from repro_torch.train import faults as tf
    _, s, _, st, lab = _guard_case(dev)
    tr = s.compile_train(guard=True)
    tr.step(st, lab)
    before = _state(s, tr)
    starts, _ = st.scene_segments()
    m = tr.step(tf.poison_nonfinite(st, rows=tuple(int(x) for x in starts)),
                lab)
    assert m["step_ok"] == 0.0 and tr.last_report.quarantined == [0, 1]
    assert tr.last_report.committed == []
    assert _same(_state(s, tr), before)


def test_bisected_commit_equals_plain_scene_step_on_card(dev):
    """NaN in scene 1: bisection commits scene 0 alone, bitwise equal to
    the plain trainer stepped on scene 0 alone from the same state (the
    kernels' batch and bucket invariance); a clean guarded step is bitwise
    the plain step."""
    from repro_torch.train import faults as tf
    from repro_torch.train import labeled_batch
    batch, s, twin, st, lab = _guard_case(dev)
    g = s.compile_train(guard=True)
    p = twin.compile_train()
    g.step(st, lab)
    p.step(st, lab)
    assert _same(_state(s, g), _state(twin, p))
    g.step(tf.poison_scene_nonfinite(st, 1), lab)
    assert g.last_report.committed == [[0]]
    assert g.last_report.quarantined == [1]
    p.step(*labeled_batch([batch[0]], twin.layout, device=dev))
    assert _same(_state(s, g), _state(twin, p))


def test_guarded_update_syncs_no_more_than_plain(dev):
    """The update itself never waits on the card, staged or plain, and
    the metrics' read costs the guarded step the same syncs as the plain
    step (the flag rides in the same copy)."""
    import warnings
    from repro_torch.train import (PointCloudTrainConfig, apply_updates,
                                   guarded_apply_updates, init_opt_state,
                                   read_metrics)
    from repro_torch.train.pointcloud import make_grad_fn
    _, s, twin, st, lab = _guard_case(dev)
    stp = st.pad_to(s._bucket(st.capacity))
    labp = torch.cat([lab, torch.full((stp.capacity - lab.shape[0],), -1,
                                      dtype=torch.int32, device=dev)])
    cfg = PointCloudTrainConfig().opt
    grad_fn = make_grad_fn(s.net, s.layout)
    named, grads, loss, acc = grad_fn(s.params, stp.packed, stp.features,
                                      labp)
    tnamed = dict(twin.params.named_parameters())
    gstate = init_opt_state(named, cfg)
    pstate = init_opt_state(tnamed, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        staged, gm = guarded_apply_updates(named, grads, gstate, cfg,
                                           loss=loss)
        _, _, pm = apply_updates(tnamed, grads, pstate, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    gm.update(loss=loss, accuracy=acc)
    pm.update(loss=loss, accuracy=acc)
    reads = []
    for metrics in (gm, pm):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                read_metrics(metrics)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        reads.append(sum("synchroniz" in str(x.message) for x in w))
    assert reads[0] == reads[1] >= 1
    torch.cuda.set_sync_debug_mode("error")
    try:
        staged.commit()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(named.values(), tnamed.values()):
        assert torch.equal(a, b)


# -- the overflow repair and one CUDA graph per key ----------------------------

from repro_torch.kernels.zdelta_window import zdelta_repair  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("search", list(SEARCHES))
@pytest.mark.parametrize("m_in,m_out", [(0, 0), (0, 1)])
def test_repair_kernel_equals_plain(dev, dtype, search, m_in, m_out):
    """A 256-word superwindow overflows on the fine level: the repair
    kernel, in place, equals its plain version in every cell (the
    overflowed ones re-searched, the others kept), and both equal the exact
    search. One launch."""
    layout, cs = _words(dev, dtype)
    K, anchors, zstep = _anchors(layout, search, m_in, m_out, dev)
    m, ovf = zdelta_superwindow_search(cs[m_in], cs[m_out], anchors, zstep,
                                       K=K, W=256, backend="cuda")
    assert int((ovf > 0).sum()) > 0
    reset_launch_counts()
    got = zdelta_repair(cs[m_in], cs[m_out], anchors, zstep, m.clone(), ovf,
                        K=K, backend="cuda")
    assert launch_counts()["zdelta_repair"] == 1
    ref = zdelta_repair(cs[m_in], cs[m_out], anchors, zstep, m, ovf, K=K,
                        backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(got, zdelta.zdelta_search(cs[m_in], cs[m_out],
                                                 anchors, zstep, K=K))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("flags", ["none", "all"])
def test_repair_kernel_flag_extremes(dev, dtype, flags):
    """The search's own map with no cell flagged (the map comes back
    untouched) and with every cell flagged (every cell re-searched: the
    exact search's map): the kernel equals its plain version exactly."""
    layout, cs = _words(dev, dtype)
    K, anchors, zstep = _anchors(layout, "G9", 0, 1, dev)
    m, ovf = zdelta_superwindow_search(cs[0], cs[1], anchors, zstep, K=K,
                                       W=256, backend="cuda")
    ovf = (torch.zeros_like(ovf) if flags == "none"
           else torch.ones_like(ovf))
    got = zdelta_repair(cs[0], cs[1], anchors, zstep, m.clone(), ovf, K=K,
                        backend="cuda")
    ref = zdelta_repair(cs[0], cs[1], anchors, zstep, m, ovf, K=K,
                        backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if flags == "none":
        assert torch.equal(got, m)
    else:
        assert torch.equal(got, zdelta.zdelta_search(cs[0], cs[1], anchors,
                                                     zstep, K=K))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_repair_kernel_cells_past_one_pass(dev, dtype):
    """More (tile, group) cells than the compact grid covers in one pass
    (4 blocks per SM, 512 cells a block), flags scattered over all of them
    (the last cell among them): the kernel, in place, equals its plain
    version exactly, and every unflagged cell keeps its entries."""
    from repro_torch.kernels.zdelta_window import (zdelta_repair_cuda,
                                                   zdelta_repair_torch)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G, K = 64, 2
    n_tiles = -(-3 * sms * 4 * 512 // (2 * G))        # 1.5 passes of cells
    g = torch.Generator(device=dev).manual_seed(5)
    pad = voxel.pad_value(dtype)
    n = 50_000
    arr = torch.randint(0, 1 << 22, (n,), generator=g, device=dev)
    arr = torch.unique(arr).to(dtype)
    arr = torch.cat([arr, torch.full((64,), pad, dtype=dtype, device=dev)])
    rows = n_tiles * 128
    pick = torch.randint(0, arr.shape[0] - 64, (rows,), generator=g,
                         device=dev)
    outp = arr[pick] - 3
    outp[torch.rand(rows, generator=g, device=dev) < 0.05] = pad
    out2d = outp.reshape(n_tiles, 128)
    anchors = torch.arange(G, device=dev).to(dtype) - 2
    ovf = (torch.rand((n_tiles, G), generator=g, device=dev) < 0.01)
    ovf[-1, -1] = True
    ovf = ovf.to(torch.int32) * torch.randint(
        1, 9, (n_tiles, G), generator=g, device=dev, dtype=torch.int32)
    m0 = torch.full((rows, G * K), -7, dtype=torch.int32, device=dev)
    got = zdelta_repair_cuda(arr, out2d, anchors, 1, m0.clone(), ovf, K=K)
    ref = zdelta_repair_torch(arr, out2d, anchors, 1, m0, ovf, K=K)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    kept = (ovf == 0).repeat_interleave(128, 0).repeat_interleave(K, 1)
    assert bool((got[kept] == -7).all())
    assert bool((got[~kept] != -7).all())


def _graph_case(dev, name, **kw):
    """A graph session of a narrow ``name`` net, an eager one with the same
    weights, and a one-scene and a two-scene input (two buckets)."""
    batch = scenes.scene_batch(seed=3, batch=2, kind="outdoor",
                               extent=(160, 160, 32), overlap=0.5)
    channels = 4 if name == "minkunet42" else 5
    rng = np.random.default_rng(1)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), channels))
               .astype(np.float32)) for sc in batch]
    net = pc.NETWORKS[name](width=(16, 16, 32, 32))
    g = compile_network(net, batch[0].layout, batch=2, device=dev, **kw)
    e = compile_network(g.net, batch[0].layout, batch=2, params=g.params,
                        device=dev, cuda_graphs=False)
    a = SparseTensor.from_point_clouds(clouds[:1], g.layout, device=dev)
    b = SparseTensor.from_point_clouds(clouds, g.layout, device=dev)
    return g, e, a, b


def _same_out(x, y):
    return (torch.equal(x.features, y.features)
            and torch.equal(x.packed, y.packed)
            and torch.equal(x.count, y.count))


@pytest.mark.parametrize("name", ["minkunet42", "centerpoint_large"])
def test_graph_replay_equals_eager_out_of_order(dev, name):
    """Two keys captured A then B and replayed B, A, B: every replay bitwise
    the eager session's call, A's first result untouched by the later
    replays (results never alias the graphs' memory), one graph per key,
    and no kernel launched by a replay."""
    g, e, a, b = _graph_case(dev, name)
    first = g(a)
    kept = first.features.clone()
    assert _same_out(g(b), e(b)) and _same_out(first, e(a))
    for st in (b, a, b):
        want = e(st)
        reset_launch_counts()
        got = g(st)
        assert not any(launch_counts().values())
        assert _same_out(got, want)
    assert torch.equal(first.features, kept)
    assert g.compile_count == 2
    assert g.metrics.counter("session_graph_captures").value == 2
    assert g.metrics.counter("session_graph_replays").value == 5


def test_overflowing_windows_served_from_the_graph(dev):
    """CenterPoint with every window held to 256 words: the plan overflows
    and repairs cells on the card inside the graph, and the replay is
    bitwise the eager call, with the same overflow counts."""
    from repro_torch.core.tuner import LayerTuneResult
    net = pc.centerpoint_large(width=(16, 16, 32, 32))
    small = LayerTuneResult(t_best=3, backend="cuda", bm=0, bn=0,
                            window=256, per_config={}, mode="measure")
    g, e, _, b = _graph_case(dev, "centerpoint_large",
                             tuner={s.name: small for s in net.specs})
    out, health = g.run_with_health(b)
    ref, ref_h = e.run_with_health(b)
    assert sum(health.window_overflow_cells.values()) > 0
    assert health == ref_h and _same_out(out, ref)
    assert _same_out(g(b), ref)


def test_trainer_step_then_replay_serves_new_weights(dev):
    """The trainer updates the parameters in place, so the captured graph
    serves the new weights at once, bitwise as an eager session on the
    same tensors; reassigning ``params`` drops the key."""
    from repro_torch.train import labeled_batch
    batch = scenes.scene_batch(seed=3, batch=2, kind="outdoor",
                               extent=(160, 160, 32), overlap=0.5,
                               labels=True, n_classes=8)
    net = pc.minkunet42(width=(16, 16, 32, 32), n_classes=8)
    s = compile_network(net, batch[0].layout, batch=2, device=dev)
    e = compile_network(net, batch[0].layout, batch=2, params=s.params,
                        device=dev, cuda_graphs=False)
    st, lab = labeled_batch(batch, s.layout, device=dev)
    before = s(st).features.clone()
    s.compile_train().step(st, lab)
    after = s(st)
    assert s.compile_count == 1
    assert _same_out(after, e(st))
    assert not torch.equal(after.features, before)
    s.params = pc.init_pointcloud(net, seed=4, device=dev)
    assert s.compile_count == 0


def test_session_and_decode_bodies_do_not_sync(dev):
    """After one call (the library, cuBLAS and every device constant
    built), the session body of both networks and the LM decode body run
    under the sync debug mode "error": nothing waits on the card and
    nothing is copied from the host, as a capture needs."""
    bodies = []
    for name in ("minkunet42", "centerpoint_large"):
        _, e, _, b = _graph_case(dev, name)
        e(b)
        stp = b.pad_to(e._bucket(b.capacity))
        bodies.append(lambda e=e, stp=stp: e._body(0, stp.packed,
                                                    stp.features))
    cfg = _tiny_lm("bfloat16")
    eng = ServeEngine(cfg, lm.init_params(cfg, 0, device=dev)[0],
                      batch_slots=2, cache_len=96, cuda_graphs=False)
    eng.submit(Request(prompt=np.arange(9, dtype=np.int32), max_new=4))
    eng.step()
    bodies.append(eng._decode_body)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            outs = [fn() for fn in bodies]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(o[0].float()).all()) for o in outs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_graph_tokens_equal_eager(dev, dtype):
    """The slot engine's decode graph (captured at the first step, replayed
    every step) gives the eager step's greedy tokens, more requests than
    slots."""
    cfg = _tiny_lm(dtype)
    params = lm.init_params(cfg, 0, device=dev)[0]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (7, 70, 12)]
    outs, engines = {}, {}
    for graphs in (True, False):
        reqs = [Request(prompt=p, max_new=6) for p in prompts]
        engines[graphs] = ServeEngine(cfg, params, batch_slots=2,
                                      cache_len=96, cuda_graphs=graphs)
        engines[graphs].run(list(reqs))
        outs[graphs] = [r.out for r in reqs]
    assert outs[True] == outs[False]
    assert engines[True]._graph is not None and engines[False]._graph is None
