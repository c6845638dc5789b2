"""Weight-stationary and hybrid dataflows of the port against the JAX
package on the CPU: ``weight_stationary`` / ``hybrid`` against the XLA
path (fp32 within 1e-5 relative; the Pallas-interpret WS differs from XLA
under capacity overflow and is not the oracle), the kept map
integer-exact (the kernel's pack: ``test_torch_ws_pack.py``), CenterPoint-Large end to end against the
JAX session, and the session's contracts on a hybrid network: batch of 2
bitwise equal to single runs, and overflow escalation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SparseTensor as JST
from repro.core import dataflow as jdf
from repro.core import voxel as jvx
from repro.core import zdelta as jzd
from repro.core.kernel_map import KernelMap as JKM
from repro.data import scenes as jscenes
from repro.models import pointcloud as jpc
from repro.serve import compile_network as j_compile

from repro_torch.convert import params_from_jax
from repro_torch.core import dataflow as tdf
from repro_torch.core.kernel_map import KernelMap as TKM
from repro_torch.core.kernel_map import l1_norm_max, l1_partition
from repro_torch.core.packing import BitLayout
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.kernels import ops
from repro_torch.models import pointcloud as tpc
from repro_torch.serve import compile_network

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

CPU = "cpu"


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _close(got, ref, rel):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


LAYERS = {"sub": (0, 0), "down": (0, 1), "up": (1, 0)}


def _case(K, layer, cin, cout, seed=0):
    """Kernel map of one layer (from the JAX search) of an indoor room,
    features and weights from a numpy seed."""
    sc = jscenes.indoor_scene(seed + 11, room=(28, 24, 16))
    p = np.asarray(jscenes.pack_scene(sc))
    cs = dict(zip((0, 1), jvx.downsample_all(
        jvx.build_coord_set(jnp.asarray(p)), sc.layout, (0, 1))))
    m_in, m_out = LAYERS[layer]
    stride = 1 << min(m_in, m_out)
    _, anch, z = jzd.zdelta_offsets(K, stride, sc.layout)
    m = np.asarray(jzd.zdelta_search(cs[m_in], cs[m_out], anch, z, K=K))
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(cs[m_in].capacity, cin)).astype(np.float32)
    f[int(cs[m_in].count):] = 0
    w = (rng.normal(size=(K ** 3, cin, cout)) / np.sqrt(cin * K ** 3)).astype(
        np.float32)
    return f, m, w, cs[m_out].count, stride


def _capacity(m, kind):
    """Lossless (the row count) or below the largest column (drops)."""
    top = int((m >= 0).sum(0).max())
    return m.shape[0] if kind == "lossless" else max(1, top // 3)


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("layer", list(LAYERS))
@pytest.mark.parametrize("cap", ["lossless", "lossy"])
def test_weight_stationary_matches_xla(K, layer, cap):
    f, m, w, *_ = _case(K, layer, cin=6, cout=10, seed=K)
    c = _capacity(m, cap)
    ref = np.asarray(jdf.weight_stationary(
        jnp.asarray(f), jnp.asarray(m), jnp.asarray(w), capacity=c,
        backend="xla"))
    got = tdf.weight_stationary(T(f), T(m), T(w), capacity=c)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    _close(N(got), ref, 1e-5)
    kept = np.asarray(jdf.ws_kept_map(jnp.asarray(m), c))
    np.testing.assert_array_equal(N(tdf.ws_kept_map(T(m), c)), kept)
    if cap == "lossy":
        assert (kept < 0).sum() > (m < 0).sum()          # pairs dropped
    # WS over the kept map computes the same function as OS over it
    _close(N(tdf.output_stationary(T(f), T(kept), T(w))), ref, 1e-5)


def test_weight_stationary_bf16_matches_xla():
    f, m, w, *_ = _case(3, "sub", cin=8, cout=16)
    fb = jnp.asarray(f).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    c = _capacity(m, "lossy")
    ref = np.asarray(jdf.ws_xla(fb, jnp.asarray(m), wb, capacity=c)
                     .astype(jnp.float32))
    got = tdf.weight_stationary(T(f).bfloat16(), T(m), T(w).bfloat16(),
                                capacity=c)
    assert got.dtype == torch.bfloat16
    _close(N(got.float()), ref, 2e-2)


def test_ws_with_an_empty_column():
    f, m, w, *_ = _case(3, "sub", cin=4, cout=6)
    m = m.copy()
    m[:, 4] = -1
    ref = np.asarray(jdf.ws_xla(jnp.asarray(f), jnp.asarray(m),
                                jnp.asarray(w), capacity=m.shape[0]))
    _close(N(tdf.weight_stationary(T(f), T(m), T(w), capacity=m.shape[0])),
           ref, 1e-5)


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("t", ["zero", "three", "all"])
def test_hybrid_matches_xla(K, t):
    """t = 0 (all WS), 3, and L1NormMax + 1 (all OS), lossy WS capacity."""
    f, m, w, cnt, stride = _case(K, "sub", cin=5, cout=7, seed=K + 1)
    tv = {"zero": 0, "three": 3, "all": l1_norm_max(K, stride) + 1}[t]
    c = _capacity(m, "lossy")
    ref = np.asarray(jdf.hybrid(
        jnp.asarray(f), JKM(m=jnp.asarray(m), out_count=cnt, in_count=cnt),
        jnp.asarray(w), K=K, stride=stride, t=tv, ws_capacity=c,
        backend="xla"))
    got = tdf.hybrid(T(f), TKM(m=T(m), out_count=torch.tensor(int(cnt)),
                               in_count=torch.tensor(int(cnt))),
                     T(w), K=K, stride=stride, t=tv, ws_capacity=c)
    _close(N(got), ref, 1e-5)


def test_ws_overflow_diagnostic():
    _, m, *_ = _case(3, "sub", cin=1, cout=1)
    km = TKM(m=T(m), out_count=torch.tensor(0), in_count=torch.tensor(0))
    jkm = JKM(m=jnp.asarray(m), out_count=0, in_count=0)
    cols = np.arange(5, 20)
    top = int((m[:, cols] >= 0).sum(0).max())
    for c in (top - 1, top):
        assert bool(tdf.ws_overflow(km, cols, c)) == bool(
            jdf.ws_overflow(jkm, cols, c)) == (c < top)


def test_ws_tile_arguments():
    f, m, w, *_ = _case(3, "sub", cin=4, cout=8)
    a = ops.spconv_ws_fused(T(f), T(m), T(w), capacity=100, bm=128, bn=16)
    b = ops.spconv_ws_fused(T(f), T(m), T(w), capacity=100)
    assert torch.equal(a, b)
    for kw in (dict(bm=64), dict(bn=48)):
        with pytest.raises(ValueError, match="compiled"):
            ops.spconv_ws_fused(T(f), T(m), T(w), capacity=100, **kw)


# ---------------------------------------------------------------------------
# CenterPoint-Large through the session (hybrid, t = 3, K = 5)
# ---------------------------------------------------------------------------

def _clouds(kind="outdoor", extent=(96, 96, 16), seed=7, B=2):
    batch = jscenes.scene_batch(seed=seed, batch=B, kind=kind, extent=extent,
                                overlap=0.5)
    rng = np.random.default_rng(1)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), 5))
               .astype(np.float32)) for sc in batch]
    return batch[0].layout, clouds


def _tl(jl) -> BitLayout:
    return BitLayout(**dataclasses.asdict(jl))


WIDTH = (8, 8, 8, 8)


def test_centerpoint_session_matches_jax():
    """Two outdoor sweeps whose stride-8 level keeps ~400 voxels (fewer
    amplify BN rounding), the same weights: logits within
    1e-3 * max|ref| of the JAX session."""
    jl, clouds = _clouds()
    jnet = jpc.centerpoint_large(width=WIDTH)
    tnet = tpc.centerpoint_large(width=WIDTH)
    jparams = jpc.init_pointcloud(jax.random.key(0), jnet)
    js = j_compile(jnet, jl, params=jparams, batch=2, min_bucket=128)
    jo = js(JST.from_point_clouds(clouds, js.layout))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tnet,
                             device=CPU)
    ts = compile_network(tnet, _tl(jl), params=params, batch=2,
                         min_bucket=128, device=CPU)
    st = SparseTensor.from_point_clouds(clouds, ts.layout, device=CPU)
    to, health = ts.run_with_health(st)
    assert health.ok and health.replans == 0
    assert int(ts.plan(st).coords[3].count) >= 300
    n = int(jo.count)
    assert int(to.count) == n
    np.testing.assert_array_equal(N(to.packed), np.asarray(jo.packed))
    ref = np.asarray(jo.features)[:n]
    got = N(to.features)[:n]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-3 * float(np.abs(ref).max()))


def _small_session(**kw):
    jl, clouds = _clouds(kind="indoor", extent=(28, 24, 16))
    net = kw.pop("net", tpc.centerpoint_large(width=WIDTH))
    s = compile_network(net, _tl(jl), batch=2, seed=2, min_bucket=128,
                        device=CPU, **kw)
    return s, clouds


def test_centerpoint_batch_equals_single_runs_bitwise():
    s, clouds = _small_session()
    out_b = s(SparseTensor.from_point_clouds(clouds, s.layout, device=CPU))
    per_scene = out_b.unbatch()
    for i, cloud in enumerate(clouds):
        o1 = s(SparseTensor.from_point_clouds([cloud], s.layout,
                                              device=CPU)).unbatch()[0]
        n = int(o1.count)
        assert n == int(per_scene[i].count)
        assert torch.equal(per_scene[i].packed[:n], o1.packed[:n])
        assert torch.equal(per_scene[i].features[:n], o1.features[:n]), i


def test_escalation_replans_and_ends_ok():
    """A ws_capacity below the largest WS column drops pairs: the session
    replans with doubled capacity and bucket until nothing drops, and its
    logits are then bitwise those of the lossless session."""
    lossless, clouds = _small_session()
    st = SparseTensor.from_point_clouds(clouds, lossless.layout, device=CPU)
    plan = lossless.plan(st)
    top = max(int(plan.kmaps[s.name].column_counts()[T(l1_partition(
        s.K, s.offset_stride, s.t)[1]).long()].max())
        for s in lossless.net.specs)
    cap = (top + 1) // 2                       # one doubling covers it
    net = dataclasses.replace(lossless.net, specs=tuple(
        dataclasses.replace(s, ws_capacity=cap) for s in lossless.net.specs))
    s, _ = _small_session(net=net, params=lossless.params)
    out, health = s.run_with_health(st)
    ref, h0 = lossless.run_with_health(st)
    assert health.replans == 1 and health.escalation == 1 and health.ok
    assert health.bucket == 2 * h0.bucket and s.compile_count == 2
    n = int(ref.count)
    assert torch.equal(out.packed[:n], ref.packed[:n])
    assert torch.equal(out.features[:n], ref.features[:n])
    # without a replan budget the drops are reported, not hidden
    lossy, health = s.run_with_health(st, max_replans=0)
    assert not health.ok and health.total_ws_dropped > 0
    assert health.replans == 0 and health.bucket == h0.bucket
    assert not torch.equal(lossy.features[:n], ref.features[:n])
