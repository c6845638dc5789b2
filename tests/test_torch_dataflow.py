"""Parity of the port's output-stationary dataflow and sparse-conv layer
(all three dataflows) with the JAX package's XLA path (fp32 within 1e-5
relative), plus the dispatch rules of ``kernels.ops.resolve_backend``.
The weight-stationary and hybrid dataflows have their own file,
``test_torch_ws.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dataflow as jdf
from repro.core import packing as jpk
from repro.core import spconv as jsc
from repro.core import voxel as jvx
from repro.core import zdelta as jzd
from repro.core.kernel_map import KernelMap as JKM
from repro.data import scenes as jscenes

from repro_torch.core import dataflow as tdf
from repro_torch.core import spconv as tsc
from repro_torch.core.kernel_map import KernelMap as TKM
from repro_torch.core.kernel_map import l1_norm_max, l1_partition
from repro_torch.kernels import ops
from repro_torch.kernels.spconv_gather_gemm import (TILES_N, _tile_for,
                                                    spconv_gather_gemm)
from repro_torch.models import pointcloud as tpc
from repro_torch.kernels.ws_scatter_gemm import ws_scatter_gemm
from repro_torch.kernels.zdelta_window import (zdelta_superwindow_cuda,
                                               zdelta_window_cuda)

from repro.core.kernel_map import l1_partition as j_l1_partition


# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


LAYERS = {"sub": (0, 0), "down": (0, 1), "up": (1, 0)}


def _case(K, layer, cin, cout, seed=0):
    """Kernel map of one layer (from the JAX search), features and weights
    from a numpy seed."""
    sc = jscenes.indoor_scene(seed + 11, room=(28, 24, 16))
    layout = sc.layout
    p = np.asarray(jscenes.pack_scene(sc))
    levels = (0, 1)
    cs = dict(zip(levels, jvx.downsample_all(
        jvx.build_coord_set(jnp.asarray(p)), layout, levels)))
    m_in, m_out = LAYERS[layer]
    stride = 1 << min(m_in, m_out)
    _, anch, z = jzd.zdelta_offsets(K, stride, layout)
    m = np.asarray(jzd.zdelta_search(cs[m_in], cs[m_out], anch, z, K=K))
    rng = np.random.default_rng(seed)
    n_in = cs[m_in].capacity
    f = rng.normal(size=(n_in, cin)).astype(np.float32)
    f[int(cs[m_in].count):] = 0
    w = (rng.normal(size=(K ** 3, cin, cout)) / np.sqrt(cin * K ** 3)).astype(
        np.float32)
    return f, m, w, cs, m_in, m_out


def _close(got, ref, rel):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("layer", list(LAYERS))
@pytest.mark.parametrize("fuse", [False, True])
def test_output_stationary_matches_xla(K, layer, fuse):
    f, m, w, *_ = _case(K, layer, cin=6, cout=10)
    ref = np.asarray(jdf.output_stationary(jnp.asarray(f), jnp.asarray(m),
                                           jnp.asarray(w), fuse=fuse,
                                           backend="xla"))
    got = N(tdf.output_stationary(T(f), T(m), T(w), fuse=fuse))
    assert got.dtype == np.float32 and got.shape == ref.shape
    _close(got, ref, 1e-5)


def test_output_stationary_column_subset_matches():
    """A hybrid-style column subset (the dense L1 offsets) of the map."""
    f, m, w, *_ = _case(3, "sub", cin=5, cout=7)
    dense, _ = l1_partition(3, 1, 2)
    np.testing.assert_array_equal(dense, j_l1_partition(3, 1, 2)[0])
    ref = np.asarray(jdf.os_xla(jnp.asarray(f), jnp.asarray(m[:, dense]),
                                jnp.asarray(w[dense])))
    got = N(tdf.output_stationary(T(f), T(m[:, dense]), T(w[dense])))
    _close(got, ref, 1e-5)


def test_output_stationary_bf16_matches_xla():
    f, m, w, *_ = _case(3, "sub", cin=8, cout=16)
    fb = jnp.asarray(f).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    ref = np.asarray(jdf.os_xla(fb, jnp.asarray(m), wb).astype(jnp.float32))
    got = tdf.output_stationary(T(f).bfloat16(), T(m), T(w).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(N(got.float()), ref, 2e-2)


def test_output_stationary_matches_dense_loop():
    """The plain OS against a direct per-row, per-offset loop in numpy."""
    f, m, w, *_ = _case(3, "down", cin=3, cout=4, seed=2)
    ref = np.zeros((m.shape[0], w.shape[2]), np.float64)
    for i, k in zip(*np.nonzero(m >= 0)):
        ref[i] += f[m[i, k]].astype(np.float64) @ w[k]
    got = N(tdf.output_stationary(T(f), T(m), T(w)))
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("K,layer", [(3, "sub"), (3, "down"), (3, "up"),
                                     (5, "sub")])
def test_apply_spconv_matches(K, layer):
    f, m, w, cs, m_in, m_out = _case(K, layer, cin=4, cout=8, seed=K)
    spec_kw = dict(name="l", cin=4, cout=8, K=K, m_in=m_in, m_out=m_out)
    jspec = jsc.SpConvSpec(**spec_kw, backend="xla")
    tspec = tsc.SpConvSpec(**spec_kw)
    b = np.random.default_rng(9).normal(size=8).astype(np.float32)
    cnt = cs[m_out].count
    ref = np.asarray(jsc.apply_spconv(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jspec, jnp.asarray(f),
        JKM(m=jnp.asarray(m), out_count=cnt, in_count=cs[m_in].count)))
    layer_mod = tsc.SpConv(tspec, T(w), T(b))
    got = N(layer_mod(T(f), TKM(m=T(m), out_count=torch.tensor(int(cnt)),
                                in_count=torch.tensor(0))))
    _close(got, ref, 1e-5)
    assert np.all(got[int(cnt):] == 0)          # PAD rows masked after bias


def test_spec_properties_match():
    for kw in (dict(K=3, m_in=0, m_out=0), dict(K=3, m_in=1, m_out=2),
               dict(K=5, m_in=3, m_out=2)):
        j = jsc.SpConvSpec("x", 4, 8, **kw)
        t = tsc.SpConvSpec("x", 4, 8, **kw)
        assert (t.submanifold, t.offset_stride, t.l1_max) == (
            j.submanifold, j.offset_stride, j.l1_max)
    assert l1_norm_max(5, 2) == 12


def test_init_spconv_is_seeded_and_scaled():
    spec = tsc.SpConvSpec("x", 16, 32, K=3)
    a = tsc.init_spconv(spec, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    b = tsc.init_spconv(spec, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    assert torch.equal(a.weight, b.weight)
    assert a.weight.shape == (27, 16, 32) and a.bias.shape == (32,)
    assert abs(float(a.weight.detach().std()) * np.sqrt(16 * 27) - 1.0) < 0.1


@pytest.mark.parametrize("dataflow,t,cap", [("ws", 0, None), ("ws", 0, 150),
                                            ("hybrid", 2, None),
                                            ("hybrid", 3, 150)])
def test_apply_spconv_ws_and_hybrid_match(dataflow, t, cap):
    """The layer with a WS or hybrid spec (bias, PAD-row mask, lossless or
    lossy ``ws_capacity``) against the JAX layer on its XLA backend."""
    f, m, w, cs, m_in, m_out = _case(3, "sub", cin=4, cout=8, seed=5)
    assert cap is None or cap < (m >= 0).sum(0).max()     # lossy: drops
    spec_kw = dict(name="l", cin=4, cout=8, K=3, dataflow=dataflow, t=t,
                   ws_capacity=cap)
    jspec = jsc.SpConvSpec(**spec_kw, backend="xla")
    tspec = tsc.SpConvSpec(**spec_kw)
    b = np.random.default_rng(9).normal(size=8).astype(np.float32)
    cnt = cs[m_out].count
    ref = np.asarray(jsc.apply_spconv(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jspec, jnp.asarray(f),
        JKM(m=jnp.asarray(m), out_count=cnt, in_count=cs[m_in].count)))
    layer_mod = tsc.SpConv(tspec, T(w), T(b))
    got = N(layer_mod(T(f), TKM(m=T(m), out_count=torch.tensor(int(cnt)),
                                in_count=torch.tensor(0))))
    _close(got, ref, 1e-5)
    assert np.all(got[int(cnt):] == 0)


def test_unknown_dataflow_raises():
    f, m, w, *_ = _case(3, "sub", cin=4, cout=8)
    layer = tsc.SpConv(tsc.SpConvSpec("l", 4, 8, dataflow="rs"), T(w), None)
    with pytest.raises(ValueError, match="dataflow"):
        layer(T(f), TKM(m=T(m), out_count=torch.tensor(1),
                        in_count=torch.tensor(1)))


# ---------------------------------------------------------------------------
# dispatch: auto -> kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------

def test_resolve_backend_rules():
    cpu = torch.zeros(1)
    assert ops.resolve_backend("auto", cpu) is False
    assert ops.resolve_backend("torch", cpu) is False
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.resolve_backend("cuda", cpu)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.resolve_backend("xla", cpu)


def test_cuda_backend_on_cpu_raises_everywhere():
    f, m, w, *_ = _case(3, "sub", cin=4, cout=8)
    with pytest.raises(ValueError):
        tdf.output_stationary(T(f), T(m), T(w), backend="cuda")
    with pytest.raises(ValueError):
        spconv_gather_gemm(T(f), T(m), T(w))
    with pytest.raises(ValueError):
        tdf.weight_stationary(T(f), T(m), T(w), capacity=10, backend="cuda")
    with pytest.raises(ValueError):
        ws_scatter_gemm(T(f), T(m), T(w), capacity=10)
    arr = torch.arange(256, dtype=torch.int32)
    with pytest.raises(ValueError):
        zdelta_superwindow_cuda(arr, arr.reshape(2, 128), arr[:9], 1, K=3,
                                SW=128, nbits=7)
    with pytest.raises(ValueError):
        zdelta_window_cuda(arr, arr.reshape(2, 128), arr[:9],
                           arr[:18].reshape(2, 9), 1, K=3, W=128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("net", sorted(tpc.NETWORKS))
def test_os_tile_choice_covers_every_layer(net, dtype):
    """The OS kernel's Cout tile is a pure function of (Cin, Cout, dtype):
    for every layer of the four point-cloud nets, forward and dF (Cin and
    Cout swapped), a compiled tile that covers Cout or is the widest; M is
    not among its inputs, so a row's add order is the same in every
    bucket."""
    import inspect
    assert list(inspect.signature(_tile_for).parameters) == ["cin", "cout",
                                                             "dtype"]
    specs = tpc.NETWORKS[net]().specs
    shapes = {(s.cin, s.cout) for s in specs}
    shapes |= {(co, ci) for ci, co in shapes}
    for cin, cout in sorted(shapes):
        bn = _tile_for(cin, cout, dtype)
        assert bn in TILES_N
        assert bn == (min(t for t in TILES_N if t >= cout)
                      if cout <= max(TILES_N) else 64)
        assert _tile_for(cin, cout, dtype) == bn


def test_os_tile_arguments():
    f, m, w, *_ = _case(3, "sub", cin=4, cout=8)
    a = ops.spconv_os_fused(T(f), T(m), T(w), bm=128, bn=32)
    b = ops.spconv_os_fused(T(f), T(m), T(w))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="128"):
        ops.spconv_os_fused(T(f), T(m), T(w), bm=64)
    with pytest.raises(ValueError, match="32"):
        ops.spconv_os_fused(T(f), T(m), T(w), bn=64)
