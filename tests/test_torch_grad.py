"""Backward passes of the port against the JAX package on the CPU: the
transposed kernel map (integer-exact), the OS / WS / hybrid gradients
against ``jax.grad`` of the reference dataflows on their XLA backend, the
``self_transpose`` shortcut, the segment-sum ⇄ segment-gather pair, the
fixed-panel row contractions and the head, AdamW, and the unfused OS
baseline (``masked_group_gemm``) against the Pallas kernel in interpret
mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dataflow as jdf
from repro.core import kernel_map as jkm
from repro.core.kernel_map import KernelMap as JKM
from repro.core.voxel import build_coord_set, downsample
from repro.core.zdelta import zdelta_offsets, zdelta_search
from repro.data import scenes as jscenes
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import segsum as jseg
from repro.kernels.masked_group_gemm import masked_group_gemm as j_mgg
from repro.models import pointcloud as jpc
from repro.train import optimizer as jopt

from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core import dataflow as tdf
from repro_torch.core.kernel_map import KernelMap as TKM
from repro_torch.core.kernel_map import transpose_kernel_map
from repro_torch.kernels import ops, segsum
from repro_torch.kernels.dw_gather_gemm import (chunked_rowdot,
                                                dw_gather_gemm,
                                                dw_gather_gemm_torch)
from repro_torch.kernels.masked_group_gemm import (masked_group_gemm,
                                                   masked_group_gemm_torch)
from repro_torch.models import pointcloud as tpc
from repro_torch.train import optimizer as topt

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _relerr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _layer(K, m_in, m_out, seed=11):
    """(kernel map, stride, in_capacity) of one layer of an indoor room,
    from the JAX search (as the reference's tests/test_grad.py)."""
    sc = jscenes.indoor_scene(seed, room=(40, 32, 16))
    cs0 = build_coord_set(jscenes.pack_scene(sc))
    cs = {0: cs0}
    for m in {m_in, m_out} - {0}:
        cs[m] = downsample(cs0, sc.layout, m)
    stride = 1 << min(m_in, m_out)
    _, anchors, zstep = zdelta_offsets(K, stride, sc.layout)
    m = zdelta_search(cs[m_in], cs[m_out], anchors, zstep, K=K)
    return np.asarray(m), stride, cs[m_in].capacity


def _operands(m, n_in, K, seed=0, cin=4, cout=6):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n_in, cin)).astype(np.float32)
    w = (rng.normal(size=(K ** 3, cin, cout)) / 5).astype(np.float32)
    ct = rng.normal(size=(m.shape[0], cout)).astype(np.float32)
    return f, w, ct


# the reference's LAYERS: submanifold level 0 / 1, down, up, K = 5
LAYERS = [(3, 0, 0), (3, 1, 1), (3, 0, 1), (3, 1, 0), (5, 0, 0)]


# ---------------------------------------------------------------------------
# transposed kernel map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,m_in,m_out", LAYERS)
def test_transpose_kernel_map_equals_jax(K, m_in, m_out):
    m, _, n_in = _layer(K, m_in, m_out)
    ref = np.asarray(jkm.transpose_kernel_map(jnp.asarray(m), n_in=n_in))
    got = transpose_kernel_map(T(m), n_in=n_in)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(N(got), ref)
    if m_in == m_out:                     # §5.4: its own transpose
        np.testing.assert_array_equal(N(got), m)


def test_transpose_kernel_map_guards_int32():
    m = torch.full((4, 27), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        transpose_kernel_map(m, n_in=2 ** 31 // 27)


# ---------------------------------------------------------------------------
# OS / WS / hybrid gradients against jax.grad of the reference
# ---------------------------------------------------------------------------

def _flows(flow, m, n_in, stride, K, cap):
    """(port loss, JAX loss) of one dataflow with cotangent ``ct``."""
    if flow == "os":
        return (lambda f, w, ct: (tdf.output_stationary(f, T(m), w) * ct)
                .sum(),
                lambda f, w, ct: (jdf.output_stationary(
                    f, jnp.asarray(m), w, backend="xla") * ct).sum())
    if flow == "ws":
        return (lambda f, w, ct: (tdf.weight_stationary(
                    f, T(m), w, capacity=cap) * ct).sum(),
                lambda f, w, ct: (jdf.weight_stationary(
                    f, jnp.asarray(m), w, capacity=cap, backend="xla")
                    * ct).sum())
    tk = TKM(m=T(m), out_count=torch.tensor(m.shape[0]),
             in_count=torch.tensor(n_in))
    jk = JKM(m=jnp.asarray(m), out_count=jnp.asarray(m.shape[0], jnp.int32),
             in_count=jnp.asarray(n_in, jnp.int32))
    kw = dict(K=K, stride=stride, t=2 * stride, ws_capacity=cap)
    return (lambda f, w, ct: (tdf.hybrid(f, tk, w, **kw) * ct).sum(),
            lambda f, w, ct: (jdf.hybrid(f, jk, w, backend="xla", **kw)
                              * ct).sum())


def _grads(flow, m, n_in, stride, K, cap, f, w, ct):
    tl, jl = _flows(flow, m, n_in, stride, K, cap)
    tf, tw = T(f).requires_grad_(), T(w).requires_grad_()
    gf, gw = torch.autograd.grad(tl(tf, tw, T(ct)), (tf, tw))
    rf, rw = jax.grad(jl, argnums=(0, 1))(jnp.asarray(f), jnp.asarray(w),
                                          jnp.asarray(ct))
    return N(gf), N(gw), np.asarray(rf), np.asarray(rw)


@pytest.mark.parametrize("K,m_in,m_out", LAYERS)
@pytest.mark.parametrize("flow", ["os", "ws", "hybrid"])
def test_grads_match_jax(flow, K, m_in, m_out):
    """(dF, dW) within 1e-5 of the gradient's scale: the same per-offset
    fp32 products, summed in the row order (dW) or over offsets in another
    library's order — the reference bounds its own reorder at 1e-6."""
    m, stride, n_in = _layer(K, m_in, m_out)
    f, w, ct = _operands(m, n_in, K)
    cap = int((m >= 0).sum(0).max()) + 4
    gf, gw, rf, rw = _grads(flow, m, n_in, stride, K, cap, f, w, ct)
    assert _relerr(gf, rf) < 1e-5, _relerr(gf, rf)
    assert _relerr(gw, rw) < 1e-5, _relerr(gw, rw)


def test_ws_lossy_grads_differentiate_dropped_function():
    """Under a capacity that drops pairs the gradients are those of the
    dropped function (the reference's, and OS over the kept map's)."""
    K = 3
    m, stride, n_in = _layer(K, 0, 0)
    f, w, ct = _operands(m, n_in, K)
    cap = int((m >= 0).sum(0).max()) // 2
    gf, gw, rf, rw = _grads("ws", m, n_in, stride, K, cap, f, w, ct)
    assert _relerr(gf, rf) < 1e-5 and _relerr(gw, rw) < 1e-5
    kept = N(tdf.ws_kept_map(T(m), cap))
    assert (kept >= 0).sum() < (m >= 0).sum()
    of, ow, _, _ = _grads("os", kept, n_in, stride, K, cap, f, w, ct)
    assert _relerr(gf, of) < 1e-5 and _relerr(gw, ow) < 1e-5


@pytest.mark.parametrize("flow", ["os", "ws", "hybrid"])
def test_self_transpose_is_bitwise(flow):
    """On a submanifold map the shortcut (no mirror scatter) gives the
    mirror-scatter path's gradients bit for bit."""
    K = 3
    m, stride, n_in = _layer(K, 0, 0)
    f, w, ct = _operands(m, n_in, K)
    cap = m.shape[0]          # statically lossless: the WS shortcut's guard
    tk = TKM(m=T(m), out_count=torch.tensor(m.shape[0]),
             in_count=torch.tensor(n_in))

    def grads(st):
        tf, tw = T(f).requires_grad_(), T(w).requires_grad_()
        if flow == "os":
            out = tdf.output_stationary(tf, T(m), tw, self_transpose=st)
        elif flow == "ws":
            out = tdf.weight_stationary(tf, T(m), tw, capacity=cap,
                                        self_transpose=st)
        else:
            out = tdf.hybrid(tf, tk, tw, K=K, stride=stride, t=2,
                             ws_capacity=cap, self_transpose=st)
        return torch.autograd.grad((out * T(ct)).sum(), (tf, tw))

    for a, b in zip(grads(False), grads(True)):
        assert torch.equal(a, b)


def test_unneeded_df_is_skipped(monkeypatch):
    """A dF nobody asks for is not computed, and dW is the same either
    way."""
    m, _, n_in = _layer(3, 0, 1)
    f, w, ct = _operands(m, n_in, 3)
    calls = []
    real = tdf._os_primal
    monkeypatch.setattr(tdf, "_os_primal",
                        lambda *a: calls.append(1) or real(*a))

    def dw(f_grad):
        tf, tw = T(f).requires_grad_(f_grad), T(w).requires_grad_()
        out = tdf.output_stationary(tf, T(m), tw)
        return torch.autograd.grad((out * T(ct)).sum(), tw)[0]

    a = dw(True)
    assert len(calls) == 2            # forward + dF
    b = dw(False)
    assert len(calls) == 3            # forward only
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# fixed-panel contractions and the head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [64, 256])
def test_chunked_rowdot_matches_jax_and_is_zero_extension_invariant(q):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(700, 9)).astype(np.float32)
    g = rng.normal(size=(700, 5)).astype(np.float32)
    ref = np.asarray(jdf.chunked_rowdot(jnp.asarray(x), jnp.asarray(g), q=q))
    got = chunked_rowdot(T(x), T(g), q)
    assert _relerr(N(got), ref) < 1e-6
    xz = np.concatenate([x, np.zeros((1300, 9), np.float32)])
    gz = np.concatenate([g, rng.normal(size=(1300, 5)).astype(np.float32)])
    assert torch.equal(chunked_rowdot(T(xz), T(gz), q), got)


def test_dw_plain_version_matches_jax_and_needs_a_card_for_the_kernel():
    m, _, n_in = _layer(3, 0, 1)
    f, _, ct = _operands(m, n_in, 3, cout=7)
    ref = np.asarray(jdf._dw_per_offset(jnp.asarray(f), jnp.asarray(m),
                                        jnp.asarray(ct), jnp.float32))
    got = ops.spconv_dw_fused(T(f), T(m), T(ct))
    assert got.shape == (27, 4, 7) and got.dtype == torch.float32
    assert _relerr(N(got), ref) < 1e-6
    assert torch.equal(got, dw_gather_gemm_torch(T(f), T(m), T(ct)))
    with pytest.raises(ValueError, match="CUDA"):
        dw_gather_gemm(T(f), T(m), T(ct))



def test_panel_counts_match_enumeration_and_zero_extension():
    """Valid rows per (offset, panel) against a loop over the rows; PAD rows
    (m = -1) appended by a larger bucket add empty panels and change no
    count."""
    from repro_torch.kernels.dw_gather_gemm import panel_counts
    rng = np.random.default_rng(5)
    m = rng.integers(-1, 50, size=(1000, 4)).astype(np.int32)
    m[:, 2] = -1
    m[300:700, 1] = -1
    got = N(panel_counts(T(m), q=256))
    want = np.zeros((4, 4), np.int64)
    for r in range(1000):
        for k in range(4):
            want[k, r // 256] += m[r, k] >= 0
    np.testing.assert_array_equal(got, want)
    mz = np.concatenate([m, np.full((1500, 4), -1, np.int32)])
    gz = N(panel_counts(T(mz), q=256))
    assert gz.shape == (4, 10)
    np.testing.assert_array_equal(gz[:, :4], want)
    assert not gz[:, 4:].any()


def test_dw_tile_covers_each_width_with_least_padding():
    """The kernel's Cin x Cout tile, in 32-channel units, pads each width
    least among the compiled units (the wider on a tie) and never depends
    on M."""
    from repro_torch.kernels.dw_gather_gemm import TILE_UNITS, _tile_for
    for c in range(1, 300):
        mi, ni = _tile_for(c, c, torch.float32)
        assert mi == ni and mi in TILE_UNITS
        pad = {n: -(-c // (32 * n)) * 32 * n for n in TILE_UNITS}
        assert pad[mi] == min(pad.values())
        assert all(n <= mi for n in TILE_UNITS if pad[n] == pad[mi])
    assert _tile_for(4, 32, torch.float32) == (1, 1)
    assert _tile_for(96, 96, torch.bfloat16) == (3, 3)
    assert _tile_for(256, 256, torch.float32) == (2, 2)


def test_rowdot_matmul_grads_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1500, 12)).astype(np.float32)
    w = rng.normal(size=(12, 5)).astype(np.float32)
    ct = rng.normal(size=(1500, 5)).astype(np.float32)
    rx, rw = jax.grad(lambda x, w: (jdf.rowdot_matmul(x, w) * ct).sum(),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = T(x).requires_grad_(), T(w).requires_grad_()
    out = tdf.rowdot_matmul(tx, tw)
    assert torch.equal(out.detach(), tpc.head_matmul(T(x), T(w)))
    gx, gw = torch.autograd.grad((out * T(ct)).sum(), (tx, tw))
    assert _relerr(N(gx), rx) < 1e-6 and _relerr(N(gw), rw) < 1e-6


# ---------------------------------------------------------------------------
# segment_sum ⇄ segment_gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [[300, 0, 77], [1000]], ids=str)
def test_segment_vjps_match_jax(sizes):
    cap = 2048
    sid, starts, counts = segsum.segments_from_sizes(sizes, cap)
    S = len(sizes)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(cap, 6)).astype(np.float32)
    v = rng.normal(size=(S, 6)).astype(np.float32)
    cs = rng.normal(size=(S, 6)).astype(np.float32)
    cg = rng.normal(size=(cap, 6)).astype(np.float32)
    args = (jnp.asarray(sid), jnp.asarray(starts), jnp.asarray(counts))
    targs = (T(sid), T(starts), T(counts))
    spec = jseg.SegmentSpec(backend="xla")
    rx = jax.grad(lambda x: (jseg.segment_sum(
        x, *args, num_segments=S, spec=spec) * cs).sum())(jnp.asarray(x))
    rv = jax.grad(lambda v: (jseg.segment_gather(
        v, *args, num_segments=S, spec=spec) * cg).sum())(jnp.asarray(v))
    tx, tv = T(x).requires_grad_(), T(v).requires_grad_()
    gx, = torch.autograd.grad((segsum.segment_sum(
        tx, *targs, num_segments=S) * T(cs)).sum(), tx)
    gv, = torch.autograd.grad((segsum.segment_gather(
        tv, *targs, num_segments=S) * T(cg)).sum(), tv)
    np.testing.assert_array_equal(N(gx), np.asarray(rx))   # a gather: exact
    # the canonical schedule on both sides: bitwise
    np.testing.assert_array_equal(N(gv), np.asarray(rv))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_apply_updates_matches_jax():
    """One AdamW step from a shared state (after two JAX steps, so the
    moments are nonzero): params, mu, nu, grad norm and lr within 1e-6
    relative."""
    jnet = jpc.tiny_segnet(in_channels=4, n_classes=5, width=8, depth=2)
    tnet = tpc.tiny_segnet(in_channels=4, n_classes=5, width=8, depth=2)
    cfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20,
                           weight_decay=0.05, grad_clip=0.5)
    tcfg = topt.AdamWConfig(**cfg.__dict__)
    params = jpc.init_pointcloud(jax.random.key(2), jnet)
    rng = np.random.default_rng(6)
    rand = lambda: jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32)), params)
    state = jopt.init_opt_state(params, cfg)
    for _ in range(2):
        params, state, _ = jopt.apply_updates(params, rand(), state, cfg)
    grads = rand()
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    model = params_from_jax(np_tree(params), tnet, device="cpu")
    tstate = opt_state_from_jax(np_tree(state), tnet, device="cpu")
    tgrads = dict(params_from_jax(np_tree(grads), tnet,
                                  device="cpu").named_parameters())
    named = dict(model.named_parameters())
    jp, js, jm = jopt.apply_updates(params, grads, state, cfg)
    _, ts, tm = topt.apply_updates(named, {k: v.detach() for k, v in
                                           tgrads.items()}, tstate, tcfg)
    assert ts.step == int(js.step) == 3
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= (
        1e-6 * float(jm["grad_norm"]))
    assert abs(tm["lr"] - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
    for tree, got in ((jp, named), (js.mu, ts.mu), (js.nu, ts.nu)):
        want = params_from_jax(np_tree(tree), tnet, device="cpu")
        for k, ref in want.named_parameters():
            r = N(ref)
            np.testing.assert_allclose(N(got[k]), r, rtol=0,
                                       atol=1e-6 * np.abs(r).max())


def test_init_opt_state_and_schedule():
    cfg = topt.AdamWConfig(lr=2.0, warmup_steps=4, total_steps=10)
    jcfg = jopt.AdamWConfig(lr=2.0, warmup_steps=4, total_steps=10)
    for s in (0, 3, 4, 7, 10, 12):
        assert abs(topt.lr_at(cfg, s) - float(jopt.lr_at(jcfg, s))) < 1e-6
    st = topt.init_opt_state({"a": torch.ones(3, 2)}, cfg)
    assert st.step == 0 and not st.mu["a"].any() and not st.nu["a"].any()


# ---------------------------------------------------------------------------
# masked_group_gemm and the unfused OS entry point
# ---------------------------------------------------------------------------

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("M,Kd,Cin,Cout,bm,bn", [
    (256, 27, 32, 64, 128, 64),
    (128, 125, 16, 128, 128, 128),
    (512, 27, 64, 32, 128, 32),
    (128, 7, 8, 16, 8, 16),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_group_gemm_plain_matches_pallas(M, Kd, Cin, Cout, bm, bn,
                                                dtype):
    """The plain version against the TPU kernel in interpret mode, on the
    reference's own sweep and tolerances (tests/test_kernels.py)."""
    rng = np.random.default_rng(0)
    m = rng.integers(-1, M, (M, Kd)).astype(np.int32)
    g = rng.normal(size=(M, Kd, Cin)).astype(np.float32)
    w = (rng.normal(size=(Kd, Cin, Cout)) / np.sqrt(Cin * Kd)).astype(
        np.float32)
    jdt = getattr(jnp, dtype)
    ref = j_mgg(jnp.asarray(m), jnp.asarray(g, jdt), jnp.asarray(w, jdt),
                bm=bm, bn=bn, interpret=True)
    tdt = getattr(torch, dtype)
    got = masked_group_gemm_torch(T(m), T(g).to(tdt), T(w).to(tdt))
    assert got.dtype == tdt and got.shape == (M, Cout)
    np.testing.assert_allclose(N(got.float()),
                               np.asarray(ref, np.float32), **TOLS[dtype])


def test_masked_group_gemm_mask_is_a_multiply():
    """A non-finite value at a masked position reaches the output, as in
    the reference (mask by multiply, not by skip)."""
    m = np.array([[0, -1], [1, 1]], np.int32)
    g = np.ones((2, 2, 3), np.float32)
    g[0, 1, 0] = np.inf
    w = np.ones((2, 3, 4), np.float32)
    got = N(masked_group_gemm_torch(T(m), T(g), T(w)))
    ref = np.asarray(jref.masked_group_gemm_ref(jnp.asarray(m),
                                                jnp.asarray(g),
                                                jnp.asarray(w)))
    assert np.isnan(got[0]).all() and np.isnan(ref[0]).all()
    np.testing.assert_array_equal(got[1], ref[1])
    with pytest.raises(ValueError, match="CUDA"):
        masked_group_gemm(T(m), T(g), T(w))


@pytest.mark.parametrize("K,m_in,m_out", [(3, 0, 0), (3, 0, 1)])
def test_output_stationary_fused_matches_jax(K, m_in, m_out):
    """Against the reference's entry point on XLA (the whole map) and on the
    Pallas kernel in interpret mode (its first 256 rows: 128-row tiles)."""
    m, _, n_in = _layer(K, m_in, m_out)
    f, w, _ = _operands(m, n_in, K, cin=5, cout=7)
    for rows, impl, kw in ((m.shape[0], "xla", {}),
                           (256, "pallas", dict(interpret=True))):
        mr = m[:rows]
        ref = np.asarray(jops.output_stationary_fused(
            jnp.asarray(f), jnp.asarray(mr), jnp.asarray(w), impl=impl,
            **kw))
        got = N(ops.output_stationary_fused(T(f), T(mr), T(w)))
        assert _relerr(got, ref) < 1e-5
    # and the implicit-GEMM path computes the same function
    assert _relerr(got, N(ops.spconv_os_fused(T(f), T(mr), T(w)))) < 1e-5
