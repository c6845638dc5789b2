"""Parity of the PyTorch port's core (packing, validation, coordinate sets,
SparseTensor, z-delta search) with the JAX package, integer-exact.

Inputs come from numpy seeds and go through both packages; JAX runs on the
CPU and data crosses as numpy. The last test checks that importing every
``repro_torch`` module loads neither ``jax`` nor ``repro``.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpk
from repro.core import validate as jval
from repro.core import voxel as jvx
from repro.core import zdelta as jzd
from repro.core.sparse_tensor import SparseTensor as JST
from repro.data import scenes as jscenes

from repro_torch.core import packing as tpk
from repro_torch.core import validate as tval
from repro_torch.core import voxel as tvx
from repro_torch.core import zdelta as tzd
from repro_torch.core.sparse_tensor import SparseTensor as TST
from repro_torch.data import scenes as tscenes

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)


CPU = "cpu"


def tlayout(jl) -> tpk.BitLayout:
    return tpk.BitLayout(**dataclasses.asdict(jl))


def jlayout(tl) -> jpk.BitLayout:
    return jpk.BitLayout(**dataclasses.asdict(tl))


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _coords(rng, layout, n):
    lo = np.array([r[0] for r in layout.data_range()])
    hi = np.array([r[1] for r in layout.data_range()])
    return rng.integers(lo, hi, size=(n, 3)).astype(np.int32)


def _room(seed=3, room=(40, 32, 20)):
    sc = jscenes.indoor_scene(seed, room=room)
    return sc.coords, sc.layout


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extent,batch", [((28, 24, 16), 1), ((48, 40, 24), 2),
                                          ((1024, 1024, 40), 2),
                                          ((200, 160, 48), 4)])
def test_bitlayout_matches(extent, batch):
    jl = jpk.BitLayout.for_extent(*extent, batch=batch)
    tl = tpk.BitLayout.for_extent(*extent, batch=batch)
    assert dataclasses.asdict(jl) == dataclasses.asdict(tl)
    assert (tl.shift_x, tl.shift_y, tl.shift_z, tl.shift_b) == (
        jl.shift_x, jl.shift_y, jl.shift_z, jl.shift_b)
    assert tl.data_range() == jl.data_range()
    assert tl.capacity() == jl.capacity()
    assert dataclasses.asdict(tl.with_batch(8)) == dataclasses.asdict(
        jl.with_batch(8))
    assert tl.dtype == (torch.int32 if jl.dtype == jnp.int32 else torch.int64)


def test_bitlayout_rejects_too_wide():
    with pytest.raises(ValueError):
        tpk.BitLayout(bx=30, by=30, bz=10)
    with pytest.raises(ValueError):
        tpk.BitLayout(guard=3)


@pytest.mark.parametrize("bb", [0, 1, 2])
def test_pack_unpack_int32_matches(bb):
    rng = np.random.default_rng(bb)
    tl = tpk.BitLayout(bx=11, by=11, bz=7, bb=bb)
    jl = jlayout(tl)
    c = _coords(rng, tl, 500)
    b = rng.integers(0, max(1, 1 << bb), 500).astype(np.int32)
    jp = np.asarray(jpk.pack(jnp.asarray(c), jl, jnp.asarray(b)))
    tp = N(tpk.pack(T(c), tl, T(b)))
    assert tp.dtype == np.int32
    np.testing.assert_array_equal(tp, jp)
    jc, jb = jpk.unpack(jnp.asarray(jp), jl)
    tc, tb = tpk.unpack(T(tp), tl)
    np.testing.assert_array_equal(N(tc), np.asarray(jc))
    np.testing.assert_array_equal(N(tb), np.asarray(jb))
    np.testing.assert_array_equal(N(tc), c)


def test_pack_unpack_int64_matches_under_x64():
    rng = np.random.default_rng(5)
    tl = tpk.BitLayout(bx=16, by=16, bz=12, bb=2)
    assert tl.dtype == torch.int64
    c = _coords(rng, tl, 300)
    b = rng.integers(0, 4, 300)
    with jax.enable_x64(True):
        jl = jlayout(tl)
        jp = np.asarray(jpk.pack(jnp.asarray(c), jl, jnp.asarray(b)))
    tp = N(tpk.pack(T(c), tl, T(b)))
    np.testing.assert_array_equal(tp, jp)
    tc, tb = tpk.unpack(T(tp), tl)
    np.testing.assert_array_equal(N(tc), c)
    np.testing.assert_array_equal(N(tb), b)


@pytest.mark.parametrize("K,stride", [(3, 1), (3, 4), (5, 1), (5, 2)])
def test_offsets_match(K, stride):
    tl = tpk.BitLayout(bx=11, by=11, bz=7, bb=1)
    jl = jlayout(tl)
    og = tpk.offset_grid(K, stride)
    np.testing.assert_array_equal(og, jpk.offset_grid(K, stride))
    np.testing.assert_array_equal(tpk.offset_l1(og), jpk.offset_l1(og))
    np.testing.assert_array_equal(
        N(tpk.pack_offsets(og, tl)),
        np.asarray(jpk.pack_offsets(jnp.asarray(og), jl)))
    # offset addition is packed-native inside the guard band
    rng = np.random.default_rng(K)
    c = _coords(rng, tl, 64)
    q = tpk.pack(T(c), tl)[:, None] + tpk.pack_offsets(og, tl)[None, :]
    direct = tpk.pack(T(c[:, None, :] + og[None, :, :]), tl)
    assert torch.equal(q, direct)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_round_down_matches(m):
    rng = np.random.default_rng(m)
    tl = tpk.BitLayout(bx=11, by=11, bz=7, bb=1)
    jl = jlayout(tl)
    p = N(tpk.pack(T(_coords(rng, tl, 400)), tl,
                   T(rng.integers(0, 2, 400))))
    np.testing.assert_array_equal(
        N(tpk.round_down(T(p), tl, m)),
        np.asarray(jpk.round_down(jnp.asarray(p), jl, m)))
    assert tpk.downsample_mask(tl, m) == jpk.downsample_mask(jl, m)


def test_validate_is_a_copy():
    coords, layout = _room()
    tl = tlayout(layout)
    bad = coords.copy().astype(np.float64)
    bad[3] = [-1, 20, 20]
    bad[7, 0] = 1e9
    bad[9, 2] = 2.5
    feats = np.ones((len(bad), 2), np.float32)
    feats[11] = np.nan
    for policy in ("clip", "drop", "none"):
        jc, jf, jr = jval.validate_point_cloud(bad, feats, layout, policy)
        tc, tf, tr = tval.validate_point_cloud(bad, feats, tl, policy)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tf, jf)
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    with pytest.raises(tval.ValidationError):
        tval.validate_point_cloud(bad, feats, tl, "reject")


# ---------------------------------------------------------------------------
# coordinate sets
# ---------------------------------------------------------------------------

def _raw_packed(seed=0, dup=0.3, pad=40):
    coords, layout = _room(seed)
    rng = np.random.default_rng(seed)
    extra = coords[rng.random(len(coords)) < dup]
    raw = np.concatenate([coords, extra])
    raw = raw[rng.permutation(len(raw))]
    tl = tlayout(layout)
    p = N(tpk.pack(T(raw), tl))
    p = np.concatenate([p, np.full(pad, np.iinfo(np.int32).max, np.int32)])
    return p, layout, tl


def _cs_equal(tcs, jcs):
    np.testing.assert_array_equal(N(tcs.packed), np.asarray(jcs.packed))
    assert int(tcs.count) == int(jcs.count)


@pytest.mark.parametrize("seed", [0, 1])
def test_build_coord_set_matches(seed):
    p, layout, tl = _raw_packed(seed)
    _cs_equal(tvx.build_coord_set(T(p)), jvx.build_coord_set(jnp.asarray(p)))


@pytest.mark.parametrize("method", ["sort", "merge"])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_downsample_matches(method, m):
    p, layout, tl = _raw_packed(2)
    jv0 = jvx.build_coord_set(jnp.asarray(p))
    tv0 = tvx.build_coord_set(T(p))
    _cs_equal(tvx.downsample(tv0, tl, m, method=method),
              jvx.downsample(jv0, layout, m, method="sort"))


@pytest.mark.parametrize("method", ["sort", "merge"])
def test_downsample_all_chained_matches(method):
    p, layout, tl = _raw_packed(4)
    levels = (0, 1, 2, 3, 4)
    jl = jvx.downsample_all(jvx.build_coord_set(jnp.asarray(p)), layout,
                            levels, method="merge")
    tls = tvx.downsample_all(tvx.build_coord_set(T(p)), tl, levels,
                             method=method)
    for a, b in zip(tls, jl):
        _cs_equal(a, b)


def test_resolve_downsample_method():
    assert tvx.resolve_downsample_method("auto") == "sort"
    assert tvx.resolve_downsample_method("merge") == "merge"
    with pytest.raises(ValueError):
        tvx.resolve_downsample_method("radix")


# ---------------------------------------------------------------------------
# SparseTensor
# ---------------------------------------------------------------------------

def _clouds(B, seed=7, extent=(28, 24, 16)):
    batch = jscenes.scene_batch(seed=seed, batch=B, kind="indoor",
                                extent=extent, overlap=0.5)
    rng = np.random.default_rng(seed)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), 4))
               .astype(np.float32)) for sc in batch]
    # duplicate voxels: the first occurrence's features must win
    c0, f0 = clouds[0]
    clouds[0] = (np.concatenate([c0, c0[:17]]),
                 np.concatenate([f0, f0[:17] + 9.0]))
    return batch[0].layout, clouds


@pytest.mark.parametrize("B", [1, 2, 3])
def test_sparse_tensor_packed_words_match(B):
    layout, clouds = _clouds(B)
    cap = sum(len(c) for c, _ in clouds) + 100
    js = JST.from_point_clouds(clouds, layout, capacity=cap)
    ts = TST.from_point_clouds(clouds, tlayout(layout), capacity=cap,
                               device=CPU)
    assert dataclasses.asdict(ts.layout) == dataclasses.asdict(js.layout)
    np.testing.assert_array_equal(N(ts.packed), np.asarray(js.packed))
    np.testing.assert_array_equal(N(ts.features), np.asarray(js.features))
    assert int(ts.count) == int(js.count)
    for a, b in zip(ts.scene_segments(), js.scene_segments()):
        np.testing.assert_array_equal(a, b)
    for tu, ju in zip(ts.unbatch(), js.unbatch()):
        np.testing.assert_array_equal(N(tu.packed), np.asarray(ju.packed))
        np.testing.assert_array_equal(N(tu.features), np.asarray(ju.features))
    tc, tb = ts.coords()
    jc, jb = js.coords()
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tb, jb)


def test_sparse_tensor_single_scene_and_pad_to():
    coords, layout = _room(1)
    f = np.random.default_rng(0).normal(size=(len(coords), 3)).astype(
        np.float32)
    js = JST.from_point_cloud(coords, f, layout).pad_to(8192)
    ts = TST.from_point_cloud(coords, f, tlayout(layout),
                              device=CPU).pad_to(8192)
    np.testing.assert_array_equal(N(ts.packed), np.asarray(js.packed))
    np.testing.assert_array_equal(N(ts.features), np.asarray(js.features))
    assert ts.capacity == 8192 and ts.device.type == "cpu"
    with pytest.raises(ValueError):
        ts.pad_to(100)


def test_sparse_tensor_rejects_with_scene_index():
    layout, clouds = _clouds(2)
    c1, f1 = clouds[1]
    c1 = c1.copy()
    c1[0] = [-5, 20, 20]
    with pytest.raises(tval.ValidationError) as ei:
        TST.from_point_clouds([clouds[0], (c1, f1)], tlayout(layout),
                              device=CPU)
    assert ei.value.scene_index == 1


def test_scenes_copy_matches():
    jb = jscenes.scene_batch(seed=1, batch=2, kind="indoor",
                             extent=(32, 28, 16), overlap=0.5)
    tb = tscenes.scene_batch(seed=1, batch=2, kind="indoor",
                             extent=(32, 28, 16), overlap=0.5)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.coords, b.coords)
        assert dataclasses.asdict(a.layout) == dataclasses.asdict(b.layout)
    np.testing.assert_array_equal(
        N(tscenes.pack_scene(tb[0], capacity=8192, device=CPU)),
        np.asarray(jscenes.pack_scene(jb[0], capacity=8192)))


# ---------------------------------------------------------------------------
# z-delta search
# ---------------------------------------------------------------------------

def _levels(seed=5, room=(40, 32, 20)):
    p, layout, tl = _raw_packed(seed)
    jcs = jvx.downsample_all(jvx.build_coord_set(jnp.asarray(p)), layout,
                             (0, 1, 2))
    tcs = tvx.downsample_all(tvx.build_coord_set(T(p)), tl, (0, 1, 2))
    return layout, tl, dict(zip((0, 1, 2), jcs)), dict(zip((0, 1, 2), tcs))


# (m_in, m_out): submanifold, downsampling, inverse (up) layers
LAYERS = {"sub": (1, 1), "down": (0, 1), "up": (2, 1)}


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("layer", list(LAYERS))
def test_zdelta_search_matches(K, layer):
    layout, tl, jc, tc = _levels()
    m_in, m_out = LAYERS[layer]
    stride = 1 << min(m_in, m_out)
    _, janch, jz = jzd.zdelta_offsets(K, stride, layout)
    _, tanch, tz = tzd.zdelta_offsets(K, stride, tl, device=CPU)
    np.testing.assert_array_equal(N(tanch), np.asarray(janch))
    assert tz == jz
    jm = jzd.zdelta_search(jc[m_in], jc[m_out], janch, jz, K=K)
    tm = tzd.zdelta_search(tc[m_in], tc[m_out], tanch, tz, K=K)
    assert tm.dtype == torch.int32
    np.testing.assert_array_equal(N(tm), np.asarray(jm))
    assert (N(tm) >= 0).sum() > int(tc[m_out].count)   # real neighbours


@pytest.mark.parametrize("K", [3, 5])
def test_symmetric_search_matches(K):
    layout, tl, jc, tc = _levels(6)
    _, janch, jz = jzd.zdelta_offsets(K, 1, layout)
    _, tanch, tz = tzd.zdelta_offsets(K, 1, tl, device=CPU)
    jm = jzd.zdelta_search_symmetric(jc[0], jc[0], janch, jz, K=K)
    tm = tzd.zdelta_search_symmetric(tc[0], tc[0], tanch, tz, K=K)
    np.testing.assert_array_equal(N(tm), np.asarray(jm))
    full = tzd.zdelta_search(tc[0], tc[0], tanch, tz, K=K)
    assert torch.equal(tm, full)
    assert tzd.symmetry_anchor_count(K) == jzd.symmetry_anchor_count(K)
    np.testing.assert_array_equal(tzd.mirror_permutation(K),
                                  jzd.mirror_permutation(K))


def test_search_counter_counts():
    layout, tl, jc, tc = _levels(7)
    _, tanch, tz = tzd.zdelta_offsets(3, 1, tl, device=CPU)
    tzd.reset_search_calls()
    tzd.zdelta_search(tc[0], tc[0], tanch, tz, K=3)
    tzd.zdelta_search(tc[1], tc[1], tanch, tz, K=3)
    assert tzd.search_call_count() == 2


# ---------------------------------------------------------------------------
# the port imports no JAX
# ---------------------------------------------------------------------------

def test_port_imports_no_jax():
    src = Path(__file__).resolve().parents[1] / "src"
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(src)!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert len(names) >= 20, names
assert not bad, bad
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20
