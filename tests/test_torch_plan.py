"""Parity of the port's kernel-map construction with the JAX package:
the superwindow search's plain version against the Pallas kernel in
interpret mode (maps AND overflow counters), and the network plan of every
MinkUNet-42 layer on both port engines against the JAX search, all
integer-exact.
"""
import dataclasses

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

from repro_torch.core import packing as tpk
from repro_torch.core import voxel as tvx
from repro_torch.core import zdelta as tzd
from repro_torch.core.network_plan import (PLAN_BM, build_network_plan,
                                           plan_levels)
from repro_torch.core.spconv import SpConvSpec
from repro_torch.kernels.zdelta_window import (
    zdelta_superwindow_search as t_superwindow)
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
    p, jl, tl = _batch_packed()
    with pytest.raises(NotImplementedError):
        build_network_plan(T(p), specs=(SpConvSpec("a", 4, 8),), layout=tl,
                           engine="hash")


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
