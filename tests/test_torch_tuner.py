"""The port's §5.4 tuner against the JAX package's: candidate thresholds,
the exact window sizing (int32 and int64 words), the cost model under the
reference's constants (keys equal with backends mapped xla→torch and
pallas→cuda, costs within 1e-9 relative, the same choices), the bytes
model, column density by L1 and ``apply_tuning`` — all exact; a tiny net
compiled with the same ``{layer: LayerTuneResult}`` mapping in both
packages gives logits within ``1e-3 * max|logits|``; measure mode runs on
the CPU and the session holds an oversized window to the kernel's largest.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dataflow as jdf
from repro.core import kernel_map as jkm
from repro.core import packing as jpk
from repro.core import tuner as jtu
from repro.core import voxel as jvx
from repro.core import zdelta as jzd
from repro.core.sparse_tensor import SparseTensor as JST
from repro.core.spconv import SpConvSpec as JSpec
from repro.data import scenes as jscenes
from repro.models import pointcloud as jpc
from repro.serve import compile_network as j_compile

from repro_torch.convert import params_from_jax
from repro_torch.core import dataflow as tdf
from repro_torch.core import kernel_map as tkm
from repro_torch.core import packing as tpk
from repro_torch.core import tuner as ttu
from repro_torch.core import voxel as tvx
from repro_torch.core import zdelta as tzd
from repro_torch.core.network_plan import build_network_plan
from repro_torch.core.spconv import SpConvSpec
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.kernels.zdelta_window import max_window
from repro_torch.models import pointcloud as tpc
from repro_torch.serve import compile_network

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

CPU = "cpu"
BACKEND = {"xla": "torch", "pallas": "cuda"}


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _levels(wide=False, levels=(0, 1, 2)):
    """Coordinate sets of every level in both packages, from two indoor
    rooms' words: an int32 layout, or (``wide``) an int64 one of 32 bits
    (12/12/7 + 1 batch bit) — call that under ``jax.enable_x64(True)``."""
    batch = jscenes.scene_batch(seed=3, batch=2, kind="indoor",
                                extent=(28, 24, 16), overlap=0.5)
    narrow = tpk.BitLayout(**dataclasses.asdict(batch[0].layout.with_batch(2)))
    tl = (tpk.BitLayout(bx=12, by=12, bz=7, bb=1, guard=narrow.guard)
          if wide else narrow)
    p = np.concatenate([N(tpk.pack(T(sc.coords), tl,
                                   torch.full((len(sc.coords),), b)))
                        for b, sc in enumerate(batch)])
    p = p[np.random.default_rng(3).permutation(len(p))]
    out = np.full(8192, np.iinfo(tl.np_dtype).max, tl.np_dtype)
    out[: len(p)] = p
    jl = jpk.BitLayout(**dataclasses.asdict(tl))
    jc = jvx.downsample_all(jvx.build_coord_set(jnp.asarray(out)), jl, levels)
    tc = tvx.downsample_all(tvx.build_coord_set(T(out)), tl, levels)
    return jl, tl, dict(zip(levels, jc)), dict(zip(levels, tc))


# (m_in, m_out) of a submanifold, a downsampling and an upsampling layer
LAYERS = {"sub": (1, 1), "down": (0, 1), "up": (2, 1), "sub0": (0, 0)}


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("stride", [1, 2, 4, 8])
def test_candidate_ts_equal(K, stride):
    assert ttu.candidate_ts(K, stride) == jtu.candidate_ts(K, stride)


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("layer", list(LAYERS))
def test_plan_windows_equal(wide, K, layer):
    """``plan_window`` and ``plan_superwindow`` return the reference's W,
    exactly, and the superwindow search at that W overflows nowhere."""
    with jax.enable_x64(wide):
        jl, tl, jc, tc = _levels(wide)
        m_in, m_out = LAYERS[layer]
        stride = 1 << min(m_in, m_out)
        _, janch, jz = jzd.zdelta_offsets(K, stride, jl)
        want = [fn(jc[m_in], jc[m_out], janch, jz, K=K)
                for fn in (jtu.plan_window, jtu.plan_superwindow)]
    _, tanch, tz = tzd.zdelta_offsets(K, stride, tl, device=CPU)
    got = [fn(tc[m_in], tc[m_out], tanch, tz, K=K)
           for fn in (ttu.plan_window, ttu.plan_superwindow)]
    assert got == want
    assert all(isinstance(w, int) and w > 0 for w in got)
    from repro_torch.kernels.zdelta_window import zdelta_superwindow_search
    _, ovf = zdelta_superwindow_search(tc[m_in], tc[m_out], tanch, tz, K=K,
                                       W=got[1])
    assert int(ovf.sum()) == 0


def _kmaps(K, m_in, m_out):
    """The same kernel map as each package's KernelMap."""
    jl, tl, jc, tc = _levels()
    stride = 1 << min(m_in, m_out)
    _, janch, jz = jzd.zdelta_offsets(K, stride, jl)
    _, tanch, tz = tzd.zdelta_offsets(K, stride, tl, device=CPU)
    jm = jzd.zdelta_search(jc[m_in], jc[m_out], janch, jz, K=K)
    tm = tzd.zdelta_search(tc[m_in], tc[m_out], tanch, tz, K=K)
    np.testing.assert_array_equal(N(tm), np.asarray(jm))
    return (jkm.KernelMap(m=jm, out_count=jc[m_out].count,
                          in_count=jc[m_in].count),
            tkm.KernelMap(m=tm, out_count=tc[m_out].count,
                          in_count=tc[m_in].count), stride)


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("layer", list(LAYERS))
@pytest.mark.parametrize("cin,cout,itemsize", [(8, 16, 4), (64, 32, 2)])
def test_cost_model_matches_reference(K, layer, cin, cout, itemsize):
    """Under the reference's constants: the same configurations, costs
    within 1e-9 relative, the same (t, backend, symmetry)."""
    jk, tk, stride = _kmaps(K, *LAYERS[layer])
    sub = LAYERS[layer][0] == LAYERS[layer][1]
    ref = jtu.tune_layer_cost_model(jk, K=K, stride=stride, cin=cin,
                                    cout=cout, itemsize=itemsize,
                                    submanifold=sub)
    got = ttu.tune_layer_cost_model(
        tk, K=K, stride=stride, cin=cin, cout=cout, itemsize=itemsize,
        submanifold=sub, **dataclasses.asdict(ttu.REFERENCE_COSTS))
    want = {(t, BACKEND[b], bm, bn): v
            for (t, b, bm, bn), v in ref.per_config.items()}
    assert set(got.per_config) == set(want)
    for key, v in want.items():
        assert abs(got.per_config[key] - v) <= 1e-9 * abs(v), key
    assert (got.t_best, got.backend, got.symmetry, got.window, got.mode) == (
        ref.t_best, BACKEND[ref.backend], ref.symmetry, ref.window, ref.mode)
    # the threshold-only model too
    a = jtu.tune_threshold_cost_model(jk, K=K, stride=stride, cin=cin,
                                      cout=cout)
    b = ttu.tune_threshold_cost_model(tk, K=K, stride=stride, cin=cin,
                                      cout=cout)
    assert b.t_best == a.t_best and b.per_t == pytest.approx(a.per_t,
                                                             rel=1e-9)


def test_cost_constants():
    assert ttu.REFERENCE_COSTS == ttu.CostConstants(4.0, 30.0, 8.0)
    h = ttu.H100_COSTS
    assert h.merge_cost_rows == pytest.approx(165 / 134)
    assert h.byte_cost_macs == pytest.approx(98.507, rel=1e-4)
    assert h.scatter_cost_steps == 8.0


@pytest.mark.parametrize("dataflow", ["os", "ws"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("nnz,capacity", [(None, None), (5000, 700)])
def test_hbm_bytes_model_matches_reference(dataflow, backend, nnz, capacity):
    for M, Kd, cin, cout, item in ((4096, 27, 32, 64, 4), (1000, 9, 3, 5, 2)):
        ref = jdf.hbm_bytes_model(M, Kd, cin, cout, item, backend=backend,
                                  dataflow=dataflow, nnz=nnz,
                                  capacity=capacity)
        got = tdf.hbm_bytes_model(M, Kd, cin, cout, item,
                                  backend=BACKEND[backend],
                                  dataflow=dataflow, nnz=nnz,
                                  capacity=capacity)
        assert got == ref


@pytest.mark.parametrize("K,layer", [(3, "sub"), (5, "sub0"), (3, "down")])
def test_density_by_l1_matches_reference(K, layer):
    jk, tk, stride = _kmaps(K, *LAYERS[layer])
    assert (tkm.density_by_l1(tk, K, stride)
            == jkm.density_by_l1(jk, K, stride))


def _result(pkg, backend, symmetry, window=300, t=2):
    return pkg.LayerTuneResult(t_best=t, backend=backend, bm=0, bn=0,
                               window=window, per_config={}, mode="measure",
                               symmetry=symmetry)


@pytest.mark.parametrize("symmetry", [None, True, False])
def test_apply_tuning_matches_reference(symmetry):
    for sym0 in (False, True):
        js = JSpec("l", 8, 8, K=3, dataflow="hybrid", symmetry=sym0)
        ts = SpConvSpec("l", 8, 8, K=3, dataflow="hybrid", symmetry=sym0)
        a = jtu.apply_tuning(js, _result(jtu, "xla", symmetry))
        b = ttu.apply_tuning(ts, _result(ttu, "torch", symmetry))
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        fa["backend"] = BACKEND[fa["backend"]]
        # the port's transposed-map field, which the JAX spec lacks
        assert fb.pop("transposed") is False
        assert fa == fb


def _clouds(B=2, seed=7, extent=(28, 24, 16)):
    batch = jscenes.scene_batch(seed=seed, batch=B, kind="indoor",
                                extent=extent, overlap=0.5)
    rng = np.random.default_rng(1)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), 4))
               .astype(np.float32)) for sc in batch]
    return batch[0].layout, clouds


def _tl(jl):
    return tpk.BitLayout(**dataclasses.asdict(jl))


def test_mapping_tuned_session_matches_jax():
    """One ``{layer: LayerTuneResult}`` mapping (thresholds, windows that
    overflow, half-searches) in both packages: logits within
    ``1e-3 * max|logits|`` on the same weights."""
    jl, clouds = _clouds()
    jnet = jpc.tiny_segnet(in_channels=4, n_classes=5, width=8, depth=3,
                           dataflow="hybrid")
    tnet = tpc.tiny_segnet(in_channels=4, n_classes=5, width=8, depth=3,
                           dataflow="hybrid")
    plan = {"stem": (0, True, 200), "sub0": (2, False, 0),
            "sub1": (4, None, 5000)}
    jmap = {k: _result(jtu, "xla", s, w, t) for k, (t, s, w) in plan.items()}
    tmap = {k: _result(ttu, "torch", s, w, t)
            for k, (t, s, w) in plan.items()}
    jparams = jpc.init_pointcloud(jax.random.key(0), jnet)
    js = j_compile(jnet, jl, params=jparams, batch=2, min_bucket=128,
                   tuner=jmap)
    jo = js(JST.from_point_clouds(clouds, js.layout))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tnet,
                             device=CPU)
    ts = compile_network(tnet, _tl(jl), params=params, batch=2,
                         min_bucket=128, tuner=tmap, device=CPU)
    assert [(s.t, s.symmetry, s.window) for s in ts.net.specs] == [
        (s.t, s.symmetry, s.window) for s in js.net.specs]
    assert ts.tune_report.mode == "mapping"
    assert ts.tune_report.windows_limited == {}
    to = ts(SparseTensor.from_point_clouds(clouds, ts.layout, device=CPU))
    n = int(jo.count)
    assert int(to.count) == n
    ref = np.asarray(jo.features)[:n]
    np.testing.assert_allclose(N(to.features)[:n], ref, rtol=0,
                               atol=1e-3 * float(np.abs(ref).max()))


def test_cost_model_session_matches_jax():
    """``tuner="cost_model"`` under the reference's constants tunes every
    layer as the JAX session does off the TPU (its "xla" is "torch")."""
    jl, clouds = _clouds()
    jnet = jpc.centerpoint_large(width=(8, 8, 8, 8))
    tnet = tpc.centerpoint_large(width=(8, 8, 8, 8))
    js = j_compile(jnet, jl, batch=2, min_bucket=128, tuner="cost_model",
                   tune_sample=JST.from_point_clouds(clouds[:1], jl))
    ts = compile_network(tnet, _tl(jl), batch=2, min_bucket=128,
                         tuner="cost_model", device=CPU,
                         tune_costs=ttu.REFERENCE_COSTS,
                         tune_sample=SparseTensor.from_point_clouds(
                             clouds[:1], _tl(jl), device=CPU))
    assert [(s.name, s.t, BACKEND[s.backend], s.symmetry, s.window)
            for s in js.net.specs] == [
        (s.name, s.t, s.backend, s.symmetry, s.window)
        for s in ts.net.specs]
    assert all(s.backend == "torch" for s in ts.net.specs)


def test_layer_measure_runs_on_cpu():
    """Measure mode on the CPU: a candidate of the sweep, the exact window
    for the engine's search and the half-search timed on it."""
    jl, tl, jc, tc = _levels()
    K = 3
    _, tanch, tz = tzd.zdelta_offsets(K, 2, tl, device=CPU)
    coords = (tc[1], tc[1], tanch, tz)
    m = tzd.zdelta_search(tc[1], tc[1], tanch, tz, K=K)
    kmap = tkm.KernelMap(m=m, out_count=tc[1].count, in_count=tc[1].count)
    rng = np.random.default_rng(0)
    f = T(rng.normal(size=(tc[1].capacity, 8)).astype(np.float32))
    w = T(rng.normal(size=(27, 8, 8)).astype(np.float32))
    r = ttu.tune_layer_measure(f, kmap, w, K=K, stride=2,
                               ws_capacity=m.shape[0], repeats=1,
                               coords=coords, submanifold=True)
    assert set(r.per_config) == {(t, "torch", 0, 0)
                                 for t in ttu.candidate_ts(K, 2)}
    assert (r.t_best, r.backend, r.bm, r.bn) in r.per_config
    assert r.window == ttu.plan_superwindow(*coords, K=K)
    assert isinstance(r.symmetry, bool) and len(r.sym_times) == 2
    rw = ttu.tune_layer_measure(f, kmap, w, K=K, stride=2,
                                ws_capacity=m.shape[0], repeats=1,
                                coords=coords, submanifold=True,
                                engine="zdelta_cuda_window")
    assert rw.window == ttu.plan_window(*coords, K=K)
    assert rw.symmetry is None            # that engine has no half-search
    spec = ttu.apply_tuning(SpConvSpec("l", 8, 8, K=3, m_in=1, m_out=1,
                                       dataflow="hybrid"), r)
    assert (spec.t, spec.backend, spec.window) == (r.t_best, "torch",
                                                   r.window)
    tr = ttu.tune_threshold_measure(f, kmap, w, K=K, stride=2,
                                    ws_capacity=m.shape[0], repeats=1)
    assert tr.t_best in tr.per_t
    from repro_torch.kernels.segsum import segments_from_sizes
    sid, starts, counts = segments_from_sizes([300, 200], 1024)
    x = T(rng.normal(size=(1024, 4)).astype(np.float32))
    sr = ttu.tune_segment_backend_measure(x, (T(sid), T(starts), T(counts),
                                              2), repeats=1)
    assert sr.backend == "torch" and set(sr.per_backend) == {"torch"}


def test_session_holds_window_to_the_kernels_largest():
    """A planned window above what the search kernel can stage is held to
    the largest, recorded on the report; the raw result keeps the planned
    W and the maps stay exact."""
    jl, clouds = _clouds()
    net = tpc.tiny_segnet(in_channels=4, n_classes=5, width=8, depth=2)
    big = 10 ** 6
    tmap = {"stem": _result(ttu, "torch", None, big, 0),
            "sub0": _result(ttu, "torch", True, big, 0)}
    s = compile_network(net, _tl(jl), batch=2, min_bucket=128, tuner=tmap,
                        device=CPU)
    cap = max_window("superwindow", s.layout.dtype, 9, 3)
    assert cap == 32768
    assert s.tune_report.windows_limited == {"stem": (big, cap),
                                             "sub0": (big, cap)}
    assert s.tune_report.results["stem"].window == big
    assert all(sp.window == cap for sp in s.net.specs)
    assert s.metrics.snapshot()["gauges"]["tuner_windows_limited"] == 2
    st = SparseTensor.from_point_clouds(clouds, s.layout, device=CPU)
    stp = st.pad_to(s._bucket(st.capacity))
    got = s.plan(st)
    ref = build_network_plan(stp.packed, specs=net.specs, layout=s.layout,
                             engine="zdelta")
    for sp in net.specs:
        assert torch.equal(got.kmaps[sp.name].m, ref.kmaps[sp.name].m)
    w = compile_network(net, _tl(jl), batch=2, min_bucket=128, tuner=tmap,
                        device=CPU, engine="zdelta_cuda_window")
    assert set(w.tune_report.windows_limited) == {"stem", "sub0"}
    assert compile_network(net, _tl(jl), tuner=tmap, device=CPU,
                           engine="zdelta").tune_report.windows_limited == {}
