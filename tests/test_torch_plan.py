"""Parity of the port's kernel-map construction with the JAX package:
the superwindow and per-group window searches' plain versions against the
Pallas kernels in interpret mode (maps AND overflow counters), on int32
and on int64 packed words, and the network plan of every MinkUNet-42 and
CenterPoint-Large layer on the port engines against the JAX search, all
integer-exact; an int64 layout's plan equals the int32 layout's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpk
from repro.core import voxel as jvx
from repro.core import zdelta as jzd
from repro.data import scenes as jscenes
from repro.kernels.zdelta_window import (
    zdelta_superwindow_search as j_superwindow)
from repro.kernels.zdelta_window import zdelta_window_search as j_window

from repro_torch.core import packing as tpk
from repro_torch.core import voxel as tvx
from repro_torch.core import zdelta as tzd
from repro_torch.core.network_plan import (PLAN_BM, build_network_plan,
                                           plan_levels)
from repro_torch.core.spconv import SpConvSpec
from repro_torch.kernels.zdelta_window import (
    zdelta_superwindow_search as t_superwindow)
from repro_torch.kernels.zdelta_window import zdelta_window_search as t_window
from repro_torch.models import pointcloud as tpc
from repro_torch.serve import bucket_capacity, bucket_packed

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)


CPU = "cpu"


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _batch_packed(B=2, seed=3, extent=(40, 32, 20), cap=None):
    """Raw batched packed words (unsorted, PAD tail) of a scene batch."""
    batch = jscenes.scene_batch(seed=seed, batch=B, kind="indoor",
                                extent=extent, overlap=0.5)
    jl = batch[0].layout.with_batch(B)
    tl = tpk.BitLayout(**dataclasses.asdict(jl))
    parts = [N(tpk.pack(T(sc.coords), tl, torch.full((len(sc.coords),), b)))
             for b, sc in enumerate(batch)]
    p = np.concatenate(parts)
    p = p[np.random.default_rng(seed).permutation(len(p))]
    cap = cap or bucket_capacity(len(p), min_bucket=128)
    out = np.full(cap, np.iinfo(np.int32).max, np.int32)
    out[: len(p)] = p
    return out, jl, tl


def _levels(cap=8192, levels=(0, 1, 2)):
    p, jl, tl = _batch_packed(extent=(28, 24, 16), cap=cap)
    jc = jvx.downsample_all(jvx.build_coord_set(jnp.asarray(p)), jl, levels)
    tc = tvx.downsample_all(tvx.build_coord_set(T(p)), tl, levels)
    return jl, tl, dict(zip(levels, jc)), dict(zip(levels, tc))


LAYERS = {"sub": (1, 1), "down": (0, 1), "up": (2, 1)}


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("layer", list(LAYERS))
@pytest.mark.parametrize("W", [256, 8192])
def test_superwindow_plain_matches_pallas_interpret(K, layer, W):
    """Plain superwindow == the Pallas kernel (interpret mode): maps and
    per-(tile, group) overflow counters. W=256 overflows on the fine
    levels, W=8192 covers the whole array."""
    jl, tl, jc, tc = _levels()
    m_in, m_out = LAYERS[layer]
    stride = 1 << min(m_in, m_out)
    _, janch, jz = jzd.zdelta_offsets(K, stride, jl)
    _, tanch, tz = tzd.zdelta_offsets(K, stride, tl, device=CPU)
    jm, jo = j_superwindow(jc[m_in], jc[m_out], janch, jz, K=K, W=W,
                           interpret=True)
    tm, to = t_superwindow(tc[m_in], tc[m_out], tanch, tz, K=K, W=W)
    np.testing.assert_array_equal(N(tm), np.asarray(jm))
    np.testing.assert_array_equal(N(to), np.asarray(jo))
    if W == 256:
        if layer != "up":                    # fine inputs outgrow the window
            assert int(to.sum()) > 0
    else:
        assert int(to.sum()) == 0
        full = tzd.zdelta_search(tc[m_in], tc[m_out], tanch, tz, K=K)
        assert torch.equal(tm, full)


def test_superwindow_anchor_subset_matches():
    """A §5.4 half-search subset of anchors: same column layout as JAX."""
    jl, tl, jc, tc = _levels()
    K = 3
    g = tzd.symmetry_anchor_count(K)
    _, janch, jz = jzd.zdelta_offsets(K, 1, jl)
    _, tanch, tz = tzd.zdelta_offsets(K, 1, tl, device=CPU)
    jm, jo = j_superwindow(jc[0], jc[0], janch[:g], jz, K=K, W=512,
                           interpret=True)
    tm, to = t_superwindow(tc[0], tc[0], tanch[:g], tz, K=K, W=512)
    np.testing.assert_array_equal(N(tm), np.asarray(jm))
    np.testing.assert_array_equal(N(to), np.asarray(jo))


def test_superwindow_input_checks():
    jl, tl, jc, tc = _levels()
    _, tanch, tz = tzd.zdelta_offsets(3, 1, tl, device=CPU)
    with pytest.raises(ValueError):
        t_superwindow(tc[0], tc[0], tanch, tz, K=3, W=16384)   # W > N
    short = tvx.CoordSet(packed=tc[0].packed[:100], count=tc[0].count)
    with pytest.raises(ValueError):
        t_superwindow(tc[0], short, tanch, tz, K=3, W=256)     # M % 128


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("layer", list(LAYERS))
@pytest.mark.parametrize("W", [256, 512])
def test_window_plain_matches_pallas_interpret(K, layer, W):
    """Plain per-group window search == the Pallas kernel (interpret
    mode): maps and per-(tile, group) overflow counters. The fine inputs
    overflow both windows on downsampling layers."""
    jl, tl, jc, tc = _levels()
    m_in, m_out = LAYERS[layer]
    stride = 1 << min(m_in, m_out)
    _, janch, jz = jzd.zdelta_offsets(K, stride, jl)
    _, tanch, tz = tzd.zdelta_offsets(K, stride, tl, device=CPU)
    jm, jo = j_window(jc[m_in], jc[m_out], janch, jz, K=K, W=W,
                      interpret=True)
    tm, to = t_window(tc[m_in], tc[m_out], tanch, tz, K=K, W=W)
    assert tm.shape == (tc[m_out].capacity, K ** 3) and to.shape == (
        tc[m_out].capacity // PLAN_BM, K * K)
    np.testing.assert_array_equal(N(tm), np.asarray(jm))
    np.testing.assert_array_equal(N(to), np.asarray(jo))
    if layer == "down":
        assert int(to.sum()) > 0
    if int(to.sum()) == 0:
        full = tzd.zdelta_search(tc[m_in], tc[m_out], tanch, tz, K=K)
        assert torch.equal(tm, full)


def _levels64(cap=2048, levels=(0, 1, 2), per_scene=1000):
    """``_levels`` on int64 words: 1,000 voxels of each of two rooms packed
    with a 32-bit layout (12/12/7 + 1 batch bit). Call it under
    ``jax.enable_x64(True)``, as every JAX step on its words."""
    batch = jscenes.scene_batch(seed=3, batch=2, kind="indoor",
                                extent=(24, 20, 16), overlap=0.5)
    tl = tpk.BitLayout(bx=12, by=12, bz=7, bb=1, guard=batch[0].layout.guard)
    rng = np.random.default_rng(3)
    parts = [N(tpk.pack(T(sc.coords[rng.permutation(len(sc.coords))
                                    [:per_scene]]),
                        tl, torch.full((per_scene,), b)))
             for b, sc in enumerate(batch)]
    p = np.concatenate(parts)
    p = p[rng.permutation(len(p))]
    out = np.full(cap, np.iinfo(np.int64).max, np.int64)
    out[: len(p)] = p
    jl = jpk.BitLayout(**dataclasses.asdict(tl))
    jc = jvx.downsample_all(jvx.build_coord_set(jnp.asarray(out)), jl, levels)
    tc = tvx.downsample_all(tvx.build_coord_set(T(out)), tl, levels)
    assert tl.bits_total == 32 and tc[0].packed.dtype == torch.int64
    assert jc[0].packed.dtype == jnp.int64
    return jl, tl, dict(zip(levels, jc)), dict(zip(levels, tc))


@pytest.mark.parametrize("search", ["superwindow", "window"])
@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("layer", ["sub", "down"])
@pytest.mark.parametrize("W", [64, 2048])
def test_plain_matches_pallas_interpret_int64(search, K, layer, W):
    """int64 words (a 32-bit layout): the plain superwindow and per-group
    window searches equal the Pallas kernels in interpret mode under x64,
    maps and counters; W=64 overflows, W=2048 covers the whole array."""
    j_fn, t_fn = ((j_superwindow, t_superwindow) if search == "superwindow"
                  else (j_window, t_window))
    with jax.enable_x64(True):
        jl, tl, jc, tc = _levels64()
        m_in, m_out = LAYERS[layer]
        stride = 1 << min(m_in, m_out)
        _, janch, jz = jzd.zdelta_offsets(K, stride, jl)
        _, tanch, tz = tzd.zdelta_offsets(K, stride, tl, device=CPU)
        jm, jo = j_fn(jc[m_in], jc[m_out], janch, jz, K=K, W=W,
                      interpret=True)
        jm, jo = np.asarray(jm), np.asarray(jo)
    tm, to = t_fn(tc[m_in], tc[m_out], tanch, tz, K=K, W=W)
    assert tm.dtype == to.dtype == torch.int32
    np.testing.assert_array_equal(N(tm), jm)
    np.testing.assert_array_equal(N(to), jo)
    if W == 64:
        assert int(to.sum()) > 0
    else:
        assert int(to.sum()) == 0
        full = tzd.zdelta_search(tc[m_in], tc[m_out], tanch, tz, K=K)
        assert torch.equal(tm, full)


@pytest.mark.parametrize("engine", ["zdelta", "zdelta_cuda",
                                    "zdelta_cuda_window"])
def test_int64_layout_plan_equals_int32(engine):
    """The same coordinates packed in an int32 layout and in a widened
    int64 one (12/12/7 + 1 batch bit) sort in the same order, so every
    MinkUNet-42 and CenterPoint-Large layer's map is the same."""
    batch = jscenes.scene_batch(seed=3, batch=2, kind="indoor",
                                extent=(40, 32, 20), overlap=0.5)
    narrow = tpk.BitLayout(**dataclasses.asdict(batch[0].layout.with_batch(2)))
    wide = tpk.BitLayout(bx=12, by=12, bz=7, bb=1, guard=narrow.guard)
    assert narrow.dtype == torch.int32 and wide.dtype == torch.int64
    specs = (tpc.minkunet42(width=(8, 8, 8, 8)).specs
             + tpc.centerpoint_large(width=(8, 8, 8, 8)).specs)
    plans = []
    for tl in (narrow, wide):
        p = np.concatenate([N(tpk.pack(T(sc.coords), tl,
                                       torch.full((len(sc.coords),), b)))
                            for b, sc in enumerate(batch)])
        words = torch.full((bucket_capacity(len(p), min_bucket=128),),
                           tvx.pad_value(tl.dtype), dtype=tl.dtype)
        words[: len(p)] = T(p)
        plans.append(build_network_plan(words, specs=specs, layout=tl,
                                        engine=engine))
    for s in specs:
        assert torch.equal(plans[0].kmaps[s.name].m,
                           plans[1].kmaps[s.name].m), s.name


def test_window_input_checks():
    jl, tl, jc, tc = _levels()
    _, tanch, tz = tzd.zdelta_offsets(3, 1, tl, device=CPU)
    with pytest.raises(ValueError):
        t_window(tc[0], tc[0], tanch, tz, K=3, W=16384)          # W > N
    short = tvx.CoordSet(packed=tc[0].packed[:100], count=tc[0].count)
    with pytest.raises(ValueError):
        t_window(tc[0], short, tanch, tz, K=3, W=256)            # M % 128


@pytest.mark.parametrize("engine", ["zdelta_cuda", "zdelta_cuda_window"])
def test_centerpoint_plan_maps_match(engine):
    """Every CenterPoint-Large layer (K = 5, hybrid) on a kernel engine
    equals the ``"zdelta"`` plan; the per-group windows overflow on the
    fine levels and are repaired cell by cell."""
    p, jl, tl = _batch_packed(extent=(40, 32, 20))
    net = tpc.centerpoint_large(width=(8, 8, 8, 8))
    ref = build_network_plan(T(p), specs=net.specs, layout=tl,
                             engine="zdelta")
    plan = build_network_plan(T(p), specs=net.specs, layout=tl,
                              engine=engine)
    for s in net.specs:
        assert torch.equal(plan.kmaps[s.name].m, ref.kmaps[s.name].m), s.name
    repaired = sum(int(v) for v in plan.stats.values())
    assert (repaired > 0) == (engine == "zdelta_cuda_window")


def test_window_engine_never_takes_the_half_search(monkeypatch):
    """As in JAX, ``symmetry=True`` on the window engine searches every
    anchor group (the half-search stays with the superwindow engine)."""
    from repro_torch.core import network_plan
    p, jl, tl = _batch_packed()
    specs = (SpConvSpec("a", 4, 8, K=3, symmetry=True),)
    groups = []
    real = network_plan._kernel_map_search

    def spy(inputs, outputs, anchors, zstep, **kw):
        groups.append((kw["superwindow"], anchors.numel()))
        return real(inputs, outputs, anchors, zstep, **kw)
    monkeypatch.setattr(network_plan, "_kernel_map_search", spy)
    a = build_network_plan(T(p), specs=specs, layout=tl, engine="zdelta_cuda")
    b = build_network_plan(T(p), specs=specs, layout=tl,
                           engine="zdelta_cuda_window")
    assert groups == [(True, tzd.symmetry_anchor_count(3)), (False, 9)]
    assert torch.equal(a.kmaps["a"].m, b.kmaps["a"].m)


# ---------------------------------------------------------------------------
# the network plan: every MinkUNet-42 layer, both engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def minkunet_reference():
    """Coordinates of every level and the JAX z-delta map of every
    MinkUNet-42 layer, for a batch of 2 indoor rooms."""
    p, jl, tl = _batch_packed(B=2, seed=4, extent=(48, 40, 24))
    net = tpc.minkunet42(width=(8, 8, 8, 8))
    levels = plan_levels(net.specs)
    jc = dict(zip(levels, jvx.downsample_all(
        jvx.build_coord_set(jnp.asarray(p)), jl, levels)))
    maps = {}
    for s in net.specs:
        _, anch, z = jzd.zdelta_offsets(s.K, s.offset_stride, jl)
        maps[s.name] = np.asarray(jzd.zdelta_search(jc[s.m_in], jc[s.m_out],
                                                    anch, z, K=s.K))
    return p, tl, net, jc, maps


@pytest.mark.parametrize("engine", ["zdelta", "zdelta_cuda"])
def test_minkunet42_plan_maps_match(minkunet_reference, engine):
    p, tl, net, jc, maps = minkunet_reference
    plan = build_network_plan(T(p), specs=net.specs, layout=tl,
                              engine=engine)
    assert len(plan.kmaps) == 42
    for m, cs in plan.coords.items():
        np.testing.assert_array_equal(N(cs.packed), np.asarray(jc[m].packed))
        assert int(cs.count) == int(jc[m].count)
    for s in net.specs:
        km = plan.kmaps[s.name]
        np.testing.assert_array_equal(N(km.m), maps[s.name],
                                      err_msg=f"{engine} {s.name}")
        assert int(km.out_count) == int(jc[s.m_out].count)
        assert int(km.in_count) == int(jc[s.m_in].count)
        assert int(plan.stats[s.name]) == 0
        cols = (maps[s.name] >= 0).sum(0)
        np.testing.assert_array_equal(N(km.column_counts()), cols)
        np.testing.assert_array_equal(
            N(km.column_density()),
            cols.astype(np.float32)
            / np.float32(max(1, int(jc[s.m_out].count))))


def test_overflow_cells_are_repaired(minkunet_reference):
    """A window too small for the data overflows; the plan repairs the
    cells with the exact search and counts them in ``stats``."""
    p, tl, net, jc, maps = minkunet_reference
    specs = tuple(dataclasses.replace(s, window=256) for s in net.specs[:6])
    plan = build_network_plan(T(p), specs=specs, layout=tl,
                              engine="zdelta_cuda")
    assert sum(int(v) for v in plan.stats.values()) > 0
    for s in specs:
        np.testing.assert_array_equal(N(plan.kmaps[s.name].m), maps[s.name])


@pytest.mark.parametrize("engine", ["zdelta", "zdelta_cuda"])
def test_symmetry_plan_matches_full(engine):
    p, jl, tl = _batch_packed()
    specs = (SpConvSpec("a", 4, 8, K=3), SpConvSpec("b", 8, 8, K=5),
             SpConvSpec("d", 8, 8, K=3, m_in=0, m_out=1))
    sym = tuple(dataclasses.replace(s, symmetry=True) for s in specs)
    full = build_network_plan(T(p), specs=specs, layout=tl, engine=engine)
    half = build_network_plan(T(p), specs=sym, layout=tl, engine=engine)
    for s in specs:
        assert torch.equal(full.kmaps[s.name].m, half.kmaps[s.name].m)


def test_downsample_methods_give_one_plan():
    p, jl, tl = _batch_packed()
    net = tpc.minkunet42(width=(8, 8, 8, 8))
    a = build_network_plan(T(p), specs=net.specs[:8], layout=tl,
                           downsample_method="sort")
    b = build_network_plan(T(p), specs=net.specs[:8], layout=tl,
                           downsample_method="merge")
    for name in a.kmaps:
        assert torch.equal(a.kmaps[name].m, b.kmaps[name].m)


def test_unported_engine_raises():
    """An unknown engine raises; the paper's baselines are engines now."""
    p, jl, tl = _batch_packed()
    with pytest.raises(ValueError, match="unknown engine"):
        build_network_plan(T(p), specs=(SpConvSpec("a", 4, 8),), layout=tl,
                           engine="octree")
    for engine in ("bsearch", "hash"):
        plan = build_network_plan(T(p), specs=(SpConvSpec("a", 4, 8),),
                                  layout=tl, engine=engine)
        assert plan.kmaps["a"].m.shape[1] == 27


def test_bucketing_matches_reference():
    from repro.serve.bucketing import bucket_capacity as j_bucket
    from repro.serve.bucketing import bucket_packed as j_bucket_packed
    for n in (1, 128, 1024, 1025, 87806, 174082):
        assert bucket_capacity(n) == j_bucket(n)
        assert bucket_capacity(n, min_bucket=128) == j_bucket(n, min_bucket=128)
    with pytest.raises(ValueError):
        bucket_capacity(5000, max_bucket=4096)
    with pytest.raises(ValueError):
        bucket_capacity(5, min_bucket=100)
    raw = np.arange(3000, dtype=np.int32)
    np.testing.assert_array_equal(N(bucket_packed(raw, device=CPU)),
                                  np.asarray(j_bucket_packed(raw)))
    assert PLAN_BM == 128
