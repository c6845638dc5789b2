"""The paper's baselines in the port against the JAX package: the
``bsearch`` and ``hash`` engines' kernel maps (integer-exact, against the
JAX engines and against the z-delta search, on int32 and int64 words),
the hash itself, the sequential plan of Fig. 12, ``BucketedPlanner``, the
dense oracles (kernel map and downsample exactly; the dense convolution
within 1e-5 relative, its gradients within 1e-4 relative), and the
retired sliced BN (against JAX's and the port's ``_relu_bn``; never called
by a session or a training step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashmap as jhm
from repro.core import network_plan as jnp_plan
from repro.core import packing as jpk
from repro.core import reference as jref
from repro.data import scenes as jscenes
from repro.kernels import segsum as jss
from repro.models import pointcloud as jpc
from repro.serve.bucketing import BucketedPlanner as JPlanner

from repro_torch.core import hashmap as thm
from repro_torch.core import packing as tpk
from repro_torch.core import reference as tref
from repro_torch.core.network_plan import (build_network_plan, plan_levels,
                                           sequential_plan_fns)
from repro_torch.core.spconv import SpConvSpec
from repro_torch.data import scenes as tscenes
from repro_torch.kernels import segsum as tss
from repro_torch.models import pointcloud as tpc
from repro_torch.serve import BucketedPlanner, compile_network
from repro_torch.train import PointCloudTrainConfig, labeled_batch

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

CPU = "cpu"


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


# a submanifold K=3 and K=5 layer, a strided down and up layer
SPECS = (SpConvSpec("sub3", 4, 8, K=3), SpConvSpec("sub5", 8, 8, K=5),
         SpConvSpec("down", 8, 8, K=3, m_in=0, m_out=1),
         SpConvSpec("sub1", 8, 8, K=3, m_in=1, m_out=1),
         SpConvSpec("up", 8, 8, K=3, m_in=1, m_out=0))


def _jspecs():
    from repro.core.spconv import SpConvSpec as JSpec
    return tuple(JSpec(s.name, s.cin, s.cout, K=s.K, m_in=s.m_in,
                       m_out=s.m_out) for s in SPECS)


def _words(wide: bool, seed=3):
    """Raw batched words (unsorted, PAD tail) of two indoor rooms: an int32
    layout, or a widened int64 one (12/12/7 + 1 batch bit)."""
    batch = jscenes.scene_batch(seed=seed, batch=2, kind="indoor",
                                extent=(28, 24, 16), overlap=0.5)
    narrow = tpk.BitLayout(**dataclasses.asdict(batch[0].layout.with_batch(2)))
    tl = (tpk.BitLayout(bx=12, by=12, bz=7, bb=1, guard=narrow.guard)
          if wide else narrow)
    p = np.concatenate([N(tpk.pack(T(sc.coords), tl,
                                   torch.full((len(sc.coords),), b)))
                        for b, sc in enumerate(batch)])
    p = p[np.random.default_rng(seed).permutation(len(p))]
    cap = -(-len(p) // 128) * 128 + 128
    out = np.full(cap, np.iinfo(tl.np_dtype).max, tl.np_dtype)
    out[: len(p)] = p
    return out, tl, jpk.BitLayout(**dataclasses.asdict(tl))


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("engine", ["bsearch", "hash"])
def test_baseline_engines_match_jax_and_zdelta(engine, wide):
    """Every layer's map on the baseline engine equals the JAX engine's
    and the port's z-delta search's, integer-exact."""
    p, tl, jl = _words(wide)
    with jax.enable_x64(wide):
        jplan = jnp_plan.build_network_plan(jnp.asarray(p), specs=_jspecs(),
                                            layout=jl, engine=engine)
        jmaps = {k: np.asarray(v.m) for k, v in jplan.kmaps.items()}
    got = build_network_plan(T(p), specs=SPECS, layout=tl, engine=engine)
    ref = build_network_plan(T(p), specs=SPECS, layout=tl, engine="zdelta")
    for s in SPECS:
        m = got.kmaps[s.name].m
        assert m.dtype == torch.int32
        np.testing.assert_array_equal(N(m), jmaps[s.name], err_msg=s.name)
        assert torch.equal(m, ref.kmaps[s.name].m), s.name
        assert int(got.stats[s.name]) == 0
        assert int((m >= 0).sum()) > 0


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_hash_equals_jax(dtype):
    """The slot of every key (uint32 arithmetic emulated in int64) is the
    reference's, for negative, PAD and wide keys too."""
    rng = np.random.default_rng(0)
    info = np.iinfo(dtype)
    keys = np.concatenate([rng.integers(info.min, info.max, 5000,
                                        dtype=dtype),
                           np.array([0, -1, info.max, info.min], dtype)])
    with jax.enable_x64(dtype == np.int64):
        ref = np.asarray(jhm._hash(jnp.asarray(keys), 4095))
    got = N(thm._hash(T(keys), 4095))
    np.testing.assert_array_equal(got, ref)
    for cap in (1, 8, 1000, 1024, 4097):
        assert thm.table_size_for(cap) == jhm.table_size_for(cap)


def test_hash_table_holds_every_key():
    """A full build: every valid row sits in the table under its own key,
    wherever the probe chain put it, and looks itself up."""
    p, tl, _ = _words(False)
    plan = build_network_plan(T(p), specs=SPECS[:1], layout=tl)
    cs = plan.coords[0]
    tk, tv = thm.build_table(cs, table_size=thm.table_size_for(cs.capacity))
    n = int(cs.count)
    held = tv >= 0
    assert int(held.sum()) == n
    assert torch.equal(cs.packed[tv[held].long()], tk[held])
    zero = torch.zeros((1,), dtype=cs.packed.dtype)
    m = thm.hash_kernel_map(tk, tv, cs, zero, K=1)
    assert torch.equal(m[:n, 0], torch.arange(n, dtype=torch.int32))
    assert bool((m[n:] == -1).all())


def test_sequential_plan_equals_fused_plan():
    """Fig. 12's sequential baseline: every level by its own sort and every
    layer by its own function give the fused plan's coordinate sets and
    maps, and the JAX baseline's."""
    p, tl, jl = _words(False)
    fused = build_network_plan(T(p), specs=SPECS, layout=tl)
    sort_fn, level_fns, map_fns = sequential_plan_fns(SPECS, tl)
    assert set(level_fns) == set(plan_levels(SPECS)) - {0}
    v0 = sort_fn(T(p))
    coords = {0: v0, **{m: fn(v0) for m, fn in level_fns.items()}}
    j_sort, j_levels, j_maps = jnp_plan.sequential_plan_fns(_jspecs(), jl)
    jv0 = j_sort(jnp.asarray(p))
    jcoords = {0: jv0, **{m: fn(jv0) for m, fn in j_levels.items()}}
    for m, cs in coords.items():
        assert torch.equal(cs.packed, fused.coords[m].packed)
        assert int(cs.count) == int(fused.coords[m].count)
        np.testing.assert_array_equal(N(cs.packed),
                                      np.asarray(jcoords[m].packed))
    for s in SPECS:
        km = map_fns[s.name](coords[s.m_in], coords[s.m_out])
        assert torch.equal(km.m, fused.kmaps[s.name].m), s.name
        assert int(km.out_count) == int(fused.kmaps[s.name].out_count)
        jkm = j_maps[s.name](jcoords[s.m_in], jcoords[s.m_out])
        np.testing.assert_array_equal(N(km.m), np.asarray(jkm.m))


def test_bucketed_planner_counts_buckets():
    p, tl, jl = _words(False)
    raw = p[p != np.iinfo(np.int32).max]
    planner = BucketedPlanner(specs=SPECS, layout=tl, min_bucket=128,
                              device=CPU)
    jplanner = JPlanner(specs=_jspecs(), layout=jl, min_bucket=128)
    for n in (len(raw), 300, len(raw), 100):
        plan = planner.plan(raw[:n])
        jp = jplanner.plan(raw[:n])
        for s in SPECS:
            np.testing.assert_array_equal(N(plan.kmaps[s.name].m),
                                          np.asarray(jp.kmaps[s.name].m))
    assert planner.compile_count == jplanner.compile_count == 3
    assert planner.bucket_hits == jplanner.bucket_hits


# ---------------------------------------------------------------------------
# the dense oracles
# ---------------------------------------------------------------------------

def _coords(seed=0, n=120, extent=12):
    rng = np.random.default_rng(seed)
    c = np.unique(rng.integers(0, extent, size=(n, 3)), axis=0)
    return c[rng.permutation(len(c))].astype(np.int32)


@pytest.mark.parametrize("K,stride,m", [(3, 1, 0), (5, 1, 0), (3, 1, 1),
                                        (3, 2, 1)])
def test_kernel_map_and_downsample_references_equal_jax(K, stride, m):
    c = _coords(K + m)
    out = (c >> m) << m if m else c
    out = np.unique(out, axis=0) if m else out
    np.testing.assert_array_equal(
        tref.kernel_map_reference(c, out, K, stride),
        jref.kernel_map_reference(c, out, K, stride))
    np.testing.assert_array_equal(tref.downsample_reference(c, m + 1),
                                  jref.downsample_reference(c, m + 1))


@pytest.mark.parametrize("K,stride", [(3, 1), (5, 1), (3, 2)])
def test_dense_conv_reference_matches_jax(K, stride):
    """Within 1e-5 of max|ref| (relative): the same function, rounded by
    another convolution library."""
    rng = np.random.default_rng(K * stride)
    c = _coords(K)
    out = np.unique((c >> 1) << 1, axis=0) if stride == 2 else c
    f = rng.normal(size=(len(c), 4)).astype(np.float32)
    w = rng.normal(size=(K ** 3, 4, 6)).astype(np.float32)
    ref = jref.dense_conv_reference(c, f, out, w, K, stride)
    got = tref.dense_conv_reference(c, f, out, w, K, stride)
    assert got.shape == ref.shape == (len(out), 6)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("K,stride", [(3, 1), (3, 2)])
def test_dense_conv_fn_gradient_matches_jax(K, stride):
    """The differentiable oracle's value and its gradients in the features
    and the weights (torch autograd against jax.grad) within 1e-4 of each
    gradient's max|ref| (relative)."""
    rng = np.random.default_rng(3)
    c = _coords(5)
    out = np.unique((c >> 1) << 1, axis=0) if stride == 2 else c
    f = rng.normal(size=(len(c), 3)).astype(np.float32)
    w = rng.normal(size=(K ** 3, 3, 5)).astype(np.float32)
    g = rng.normal(size=(len(out), 5)).astype(np.float32)
    jfn = jref.dense_conv_fn(c, out, K, stride)
    jval, (jdf, jdw) = jax.value_and_grad(
        lambda a, b: jnp.vdot(jfn(a, b), jnp.asarray(g)), argnums=(0, 1))(
            jnp.asarray(f), jnp.asarray(w))
    tfn = tref.dense_conv_fn(c, out, K, stride)
    ft, wt = T(f).requires_grad_(True), T(w).requires_grad_(True)
    val = (tfn(ft, wt) * T(g)).sum()
    df, dw = torch.autograd.grad(val, (ft, wt))
    assert abs(val.item() - float(jval)) <= 1e-4 * abs(float(jval))
    for got, ref in ((df, jdf), (dw, jdw)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(N(got), ref, rtol=0,
                                   atol=1e-4 * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# the retired sliced BN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 4])
def test_relu_bn_sliced_matches_jax_and_segment_bn(S):
    """Against JAX's ``_relu_bn_sliced`` and the port's segment-engine BN,
    within 1e-5 absolute (unit-scale outputs; the groupings differ)."""
    rng = np.random.default_rng(S)
    cap, C = 640, 8
    sizes = [200, 111, 0, 97][:S]
    sid, starts, counts = jss.segments_from_sizes(sizes, cap)
    x = rng.normal(size=(cap, C)).astype(np.float32)
    total = sum(sizes)
    seg_j = (jnp.asarray(sid), jnp.asarray(starts), jnp.asarray(counts), S)
    seg_t = (T(sid), T(starts), T(counts), S)
    ref = np.asarray(jpc._relu_bn_sliced(jnp.asarray(x), jnp.asarray(total),
                                         None if S == 1 else seg_j))
    tpc.reset_sliced_bn_calls()
    got = N(tpc._relu_bn_sliced(T(x), torch.tensor(total),
                                None if S == 1 else seg_t))
    assert tpc.sliced_bn_call_count() == 1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    seg_bn = N(tpc._relu_bn(T(x), torch.tensor(total), seg_t))
    np.testing.assert_allclose(got, seg_bn, rtol=0, atol=1e-5)
    assert np.all(got[total:] == 0)


def test_no_session_or_training_path_calls_sliced_bn():
    sb = tscenes.scene_batch(seed=0, batch=2, kind="indoor",
                             extent=(32, 28, 16), labels=True, n_classes=6)
    net = tpc.tiny_segnet(in_channels=4, n_classes=6, width=8, depth=2)
    session = compile_network(net, sb[0].layout, batch=2, min_bucket=128,
                              device=CPU)
    st, lab = labeled_batch(sb, session.layout, device=CPU)
    tpc.reset_sliced_bn_calls()
    tss.reset_segment_calls()
    session(st)
    session.compile_train(PointCloudTrainConfig()).step(st, lab)
    assert tpc.sliced_bn_call_count() == 0
    assert tss.segment_call_count() > 0
