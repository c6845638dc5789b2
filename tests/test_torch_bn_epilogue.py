"""The fused ReLU + per-scene BN epilogue (``kernels.segsum.relu_bn_cuda``)
and the rule that picks it over the chain of torch ops after each
convolution (``models.pointcloud._conv_epilogue``).

CPU: every tensor here takes the chain (the fused kernels need CUDA fp32
rows, the kernel backend and no gradient), whose bits and gradients are
those of the bias add, row mask and ``_relu_bn`` composed by hand; the
counters see only chain layers, in a forward and in a training step.

Card (``cuda`` marker, skipped without one): the fused output bitwise the
chain's on the same tensors (fp32; one scene and S = 1, 2, 4; with and
without bias; C = 5, 16, 20, 96, 256; q = 64 and 32; NaN, ±0.0 and ±inf
rows), the same for the standardisation-first orders (``bn_relu``, ``bn``,
``bn_add_relu`` with a residual operand holding NaN, ±0.0 and ±inf), a
batch bitwise its single runs, zero extension to a larger bucket, no host
sync, the counters of an eager forward and a training step, a graph
session's logits bitwise an eager forward run through the chain, and a
graph session of the published MinkUNet: no chain layer, the fused layers
by order, its logits bitwise the chain's.
Imports no JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.spconv import (SpConv, SpConvSpec, add_bias,
                                     apply_spconv, spconv_features)
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.data import scenes
from repro_torch.kernels import launch_counts, reset_launch_counts, segsum
from repro_torch.kernels.segsum import SegmentSpec
from repro_torch.models import pointcloud as pc
from repro_torch.serve import compile_network

torch.set_num_threads(1)

CPU = "cpu"


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, NaN payloads and signs of zero included."""
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# CPU: the chain, the dispatch rule and the counters
# ---------------------------------------------------------------------------

def _tiny(device=CPU, batch=2, seed=0, width=8, depth=3):
    sb = scenes.scene_batch(seed=seed, batch=batch, kind="indoor",
                            extent=(32, 28, 16))
    net = pc.tiny_segnet(in_channels=4, n_classes=6, width=width,
                         depth=depth)
    s = compile_network(net, sb[0].layout, batch=batch, device=device,
                        cuda_graphs=False)
    rng = np.random.default_rng(seed)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), 4))
               .astype(np.float32)) for sc in sb]
    st = SparseTensor.from_point_clouds(clouds, s.layout, device=device)
    return s, st


def _plan_inputs(s, st):
    stp = st.pad_to(s._bucket(st.capacity))
    with torch.no_grad():
        plan = s.plan(stp)
    return plan, stp.features


@pytest.mark.parametrize("mode", ["no_grad", "grad", "bfloat16",
                                  "torch_backend"])
def test_cpu_forward_takes_the_chain(mode):
    """On CPU tensors the chain runs whatever the mode: under no_grad,
    under autograd, in bf16 and with the segment engine's plain
    backend; the fused counter stays 0 and every layer counts once."""
    s, st = _tiny()
    plan, feats = _plan_inputs(s, st)
    params, segment = s.params, s.segment
    if mode == "bfloat16":
        params = pc.init_pointcloud(s.net, seed=0, device=CPU,
                                    dtype=torch.bfloat16)
        feats = feats.to(torch.bfloat16)
    if mode == "torch_backend":
        segment = SegmentSpec(backend="torch")
    pc.reset_epilogue_calls()
    ctx = torch.enable_grad() if mode == "grad" else torch.no_grad()
    with ctx:
        out = pc.pointcloud_forward(params, s.net, plan, feats,
                                    layout=s.layout, segment=segment)
    n = len(s.net.specs)
    assert pc.fused_epilogue_count() == 0
    assert pc.chain_epilogue_count() == n
    assert out.requires_grad == (mode == "grad")
    pc.reset_epilogue_calls()
    assert pc.chain_epilogue_count() == pc.fused_epilogue_count() == 0


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("variant", ["bias", "no_bias", "dense"])
def test_chain_epilogue_is_the_composed_chain(batched, variant):
    """Each layer's epilogue (from the output before the bias) is bitwise
    ``_relu_bn(apply_spconv(...))``, and so are the gradients of the
    weights, the bias and the features through it."""
    s, st = _tiny(batch=2 if batched else 1, seed=3)
    plan, feats = _plan_inputs(s, st)
    segs = pc.level_segments(plan, s.layout) if batched else {}
    for spec in s.net.specs[:2]:
        layer = s.params.layers[spec.name]
        if variant == "no_bias":
            spec = dataclasses.replace(spec, bias=False)
            layer = SpConv(spec, layer.weight.detach().clone(), None)
        if variant == "dense":
            spec = dataclasses.replace(spec, dense=True)
        kmap = plan.kmaps[spec.name]
        x = torch.randn((feats.shape[0], spec.cin),
                        generator=torch.Generator().manual_seed(7))
        seg = segs.get(spec.m_out)

        def run(fused_path):
            xv = x.clone().requires_grad_(True)
            leaves = [xv] + [p for p in layer.parameters()]
            if fused_path:
                bias = None if layer.bias is None else layer.bias.to(x.dtype)
                y = pc._conv_epilogue(spconv_features(layer, spec, xv, kmap),
                                      bias, spec, kmap.out_count, seg)
            else:
                y = pc._relu_bn(apply_spconv(layer, spec, xv, kmap),
                                kmap.out_count, seg)
            g = torch.autograd.grad((y * y).sum(), leaves)
            return y.detach(), g

        (ya, ga), (yb, gb) = run(True), run(False)
        assert _same(ya, yb)
        assert all(_same(a, b) for a, b in zip(ga, gb))


def test_add_bias_masks_unless_dense_or_biasless():
    """``add_bias`` adds the bias and zeroes the PAD rows again, keeps them
    on a dense level, and returns a bias-less layer's output as it is."""
    out = torch.randn(10, 3)
    bias = torch.tensor([1.0, -2.0, 0.5])
    count = torch.tensor(6, dtype=torch.int32)
    spec = SpConvSpec("l", 2, 3)
    y = add_bias(out, bias, spec, count)
    assert _same(y[:6], out[:6] + bias) and bool((y[6:] == 0).all())
    dense = SpConvSpec("l", 2, 3, dense=True)
    assert _same(add_bias(out, bias, dense, count), out + bias)
    assert add_bias(out, None, spec, count) is out


def test_cpu_training_step_counts_only_chain_layers():
    """A training step's forward runs the chain on every layer."""
    from repro_torch.train import labeled_batch
    sb = scenes.scene_batch(seed=0, batch=2, kind="indoor",
                            extent=(32, 28, 16), labels=True, n_classes=6)
    net = pc.tiny_segnet(in_channels=4, n_classes=6, width=8, depth=3)
    s = compile_network(net, sb[0].layout, batch=2, device=CPU)
    st, lab = labeled_batch(sb, s.layout, device=CPU)
    trainer = s.compile_train()
    pc.reset_epilogue_calls()
    m = trainer.step(st, lab)
    assert np.isfinite(m["loss"])
    assert pc.fused_epilogue_count() == 0
    assert pc.chain_epilogue_count() == len(net.specs)


def test_relu_bn_cuda_refuses_cpu_and_bf16_rows():
    x = torch.randn(64, 4)
    count = torch.tensor(40, dtype=torch.int32)
    with pytest.raises(ValueError):
        segsum.relu_bn_cuda(x, count)
    with pytest.raises(ValueError):
        segsum.relu_bn_cuda(x.to(torch.bfloat16), count)


def test_bn_stats_is_the_chains_arithmetic():
    """``bn_stats`` (shared by the chain and the fused path): mean and
    rsqrt of the clamped one-pass variance, an empty segment's count held
    at 1."""
    sx = torch.tensor([[4.0, -2.0], [0.0, 0.0]])
    sx2 = torch.tensor([[10.0, 4.0], [0.0, 0.0]])
    counts = torch.tensor([2, 0], dtype=torch.int32)
    st = segsum.bn_stats(sx, sx2, counts)
    mean = sx / torch.tensor([[2.0], [1.0]])
    var = (sx2 / torch.tensor([[2.0], [1.0]]) - mean * mean).clamp(min=0.0)
    assert _same(st, torch.cat([mean, torch.rsqrt(var + 1e-5)], dim=1))


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _chain(x, bias, count, seg, mask, q):
    spec = SpConvSpec("l", 1, x.shape[1], dense=not mask)
    return pc._relu_bn(add_bias(x, bias, spec, count), count, seg,
                       segment=SegmentSpec(backend="cuda", q=q))


def _fused(x, bias, count, seg, mask, q):
    spec = SpConvSpec("l", 1, x.shape[1], dense=not mask)
    with torch.no_grad():
        return pc._conv_epilogue(x, bias, spec, count, seg,
                                 segment=SegmentSpec(backend="cuda", q=q))


def _case(dev, sizes, cap, C, seed, special=True):
    """Conv-output-like rows: normal values in the segments, junk past
    them; with ``special``, NaN, ±inf and signed zeros in a few rows and
    channels, and one channel of signed zeros only."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((cap, C), generator=g) * 2.0
    if special:
        total = sum(sizes)
        rows = torch.randint(0, max(total, 1), (12,), generator=g)
        vals = [float("nan"), float("inf"), float("-inf"), 0.0, -0.0, -0.0]
        for i, r in enumerate(rows.tolist()):
            x[r, i % min(C, 3)] = vals[i % len(vals)]
        z = torch.zeros(cap)
        z[torch.rand(cap, generator=g) < 0.5] = -0.0
        x[:, C - 1] = z
    bias = torch.randn(C, generator=g)
    bias[0] = -0.0
    return x.to(dev), bias.to(dev)


def _seg(dev, sizes, cap):
    sid, starts, counts = segsum.segments_from_sizes(sizes, cap)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (T(sid), T(starts), T(counts), len(sizes))


SEGS = {"one": None, "S1": [300], "S2": [300, 157], "S4": [64, 0, 401, 33]}


@pytest.mark.cuda
@pytest.mark.parametrize("q", [64, 32])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("segs", list(SEGS))
@pytest.mark.parametrize("C", [5, 16, 20, 96, 256])
def test_fused_epilogue_bitwise_the_chain(dev, C, segs, bias, q):
    sizes = SEGS[segs] or [333]
    cap = 1024
    x, b = _case(dev, sizes, cap, C, seed=C + q)
    count = torch.tensor(sum(sizes), dtype=torch.int32, device=dev)
    seg = None if SEGS[segs] is None else _seg(dev, sizes, cap)
    b = b if bias else None
    pc.reset_epilogue_calls()
    got = _fused(x, b, count, seg, bias, q)
    assert pc.fused_epilogue_count() == 1
    ref = _chain(x, b, count, seg, bias, q)
    torch.cuda.synchronize()
    assert _same(got, ref)
    # the NaN rows reached the output
    assert bool(torch.isnan(got).any())


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 20])
def test_fused_batch_equals_single_runs_and_zero_extension(dev, C):
    """Scene b of a batch is bitwise scene b alone (from row 0, one
    segment); a buffer twice as long with zero rows appended changes no
    row and gives +0 on the new ones."""
    sizes = [500, 0, 123, 389]
    cap = 2048
    x, b = _case(dev, sizes, cap, C, seed=11, special=False)
    count = torch.tensor(sum(sizes), dtype=torch.int32, device=dev)
    got = _fused(x, b, count, _seg(dev, sizes, cap), True, 64)
    start = 0
    for n in sizes:
        one = torch.zeros((1024, C), device=dev)
        one[:n] = x[start:start + n]
        cnt = torch.tensor(n, dtype=torch.int32, device=dev)
        y1 = _fused(one, b, cnt, None, True, 64)
        assert _same(got[start:start + n], y1[:n])
        start += n
    x2 = torch.cat([x, torch.zeros_like(x)])
    y2 = _fused(x2, b, count, _seg(dev, sizes, 2 * cap), True, 64)
    torch.cuda.synchronize()
    assert _same(y2[:cap], got)
    assert _same(y2[cap:], torch.zeros_like(x))


@pytest.mark.cuda
def test_fused_epilogue_does_not_sync(dev):
    x, b = _case(dev, [700, 200], 1024, 96, seed=5, special=False)
    count = torch.tensor(900, dtype=torch.int32, device=dev)
    seg = _seg(dev, [700, 200], 1024)
    segsum.relu_bn_cuda(x, count, seg, bias=b, mask=True)   # binds the lib
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        segsum.relu_bn_cuda(x, count, seg, bias=b, mask=True)
        segsum.relu_bn_cuda(x, count, None, bias=None, mask=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _outdoor(dev, channels, batch=2):
    sb = scenes.scene_batch(seed=3, batch=batch, kind="outdoor",
                            extent=(160, 160, 32), overlap=0.5)
    rng = np.random.default_rng(1)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), channels))
               .astype(np.float32)) for sc in sb]
    return sb, clouds


@pytest.mark.cuda
def test_counters_of_an_eager_forward_and_a_training_step(dev):
    """An eager MinkUNet-42 forward without autograd: 42 fused layers, no
    chain, 42 epilogue launches and no segment sum; a training step: the
    chain on every layer."""
    from repro_torch.train import labeled_batch
    sb = scenes.scene_batch(seed=3, batch=2, kind="outdoor",
                            extent=(160, 160, 32), overlap=0.5,
                            labels=True, n_classes=8)
    net = pc.minkunet42(width=(16, 16, 32, 32), n_classes=8)
    s = compile_network(net, sb[0].layout, batch=2, device=dev,
                        cuda_graphs=False)
    st, lab = labeled_batch(sb, s.layout, device=dev)
    pc.reset_epilogue_calls()
    reset_launch_counts()
    s(st)
    assert (pc.fused_epilogue_count(), pc.chain_epilogue_count()) == (42, 0)
    n = launch_counts()
    assert n["relu_bn"] == 42 and n["segment_sum"] == 0
    trainer = s.compile_train()
    pc.reset_epilogue_calls()
    reset_launch_counts()
    trainer.step(st, lab)
    assert (pc.fused_epilogue_count(), pc.chain_epilogue_count()) == (0, 42)
    assert launch_counts()["relu_bn"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["minkunet42", "centerpoint_large"])
def test_graph_session_logits_bitwise_the_chain(dev, name):
    """One graph call (fused epilogue) against an eager forward of the same
    parameters and plan under autograd (the chain): the logits bitwise."""
    channels = 4 if name == "minkunet42" else 5
    net = getattr(pc, name)(width=(16, 16, 32, 32))
    sb, clouds = _outdoor(dev, channels)
    s = compile_network(net, sb[0].layout, batch=2, device=dev)
    st = SparseTensor.from_point_clouds(clouds, s.layout, device=dev)
    out = s(st)
    stp = st.pad_to(s._bucket(st.capacity))
    plan = s.plan(stp)
    assert any(p.requires_grad for p in s.params.parameters())
    pc.reset_epilogue_calls()
    with torch.enable_grad():
        ref = pc.pointcloud_forward(s.params, s.net, plan, stp.features,
                                    layout=s.layout, segment=s.segment)
    assert pc.fused_epilogue_count() == 0
    assert pc.chain_epilogue_count() == len(net.specs)
    torch.cuda.synchronize()
    n = int(out.count)
    assert n > 0 and _same(out.features[:n], ref.detach()[:n])


ORDERS = {"bn_relu": 26, "bn": 7, "bn_add_relu": 16}   # layers of minkunet()


def _chain_order(x, count, seg, order, res, q):
    sp = SegmentSpec(backend="cuda", q=q)
    if order == "bn_add_relu":
        return pc._bn_add_relu(x, res, count, seg, segment=sp)
    return {"bn_relu": pc._bn_relu, "bn": pc._bn}[order](x, count, seg,
                                                        segment=sp)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [64, 32])
@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("segs", list(SEGS))
@pytest.mark.parametrize("C", [5, 16, 96, 256])
def test_fused_norm_orders_bitwise_the_chain(dev, C, segs, order, q):
    """The standardisation-first orders of a bias-free layer: fused output
    bitwise ``_bn_relu`` / ``_bn`` / ``_bn_add_relu``, one fused layer of
    that order counted; the residual holds NaN, ±inf and signed zeros, on
    valid and PAD rows."""
    sizes = SEGS[segs] or [333]
    cap = 1024
    x, _ = _case(dev, sizes, cap, C, seed=3 * C + q)
    res, _ = _case(dev, sizes, cap, C, seed=5 * C + q)
    res = res if order == "bn_add_relu" else None
    count = torch.tensor(sum(sizes), dtype=torch.int32, device=dev)
    seg = None if SEGS[segs] is None else _seg(dev, sizes, cap)
    spec = SpConvSpec("l", 1, C, bias=False)
    pc.reset_epilogue_calls()
    with torch.no_grad():
        got = pc._conv_epilogue(x, None, spec, count, seg, order=order,
                                residual=res,
                                segment=SegmentSpec(backend="cuda", q=q))
    assert pc.fused_epilogue_count() == pc.EPILOGUE_CALLS[order] == 1
    ref = _chain_order(x, count, seg, order, res, q)
    torch.cuda.synchronize()
    assert _same(got, ref)
    assert bool(torch.isnan(got).any())


@pytest.mark.cuda
def test_fused_norm_orders_batch_equals_single_runs(dev):
    """Scene b of a batch, in each order, is bitwise scene b alone."""
    sizes = [500, 0, 123, 389]
    cap, C = 2048, 20
    x, _ = _case(dev, sizes, cap, C, seed=17, special=False)
    res, _ = _case(dev, sizes, cap, C, seed=18, special=False)
    count = torch.tensor(sum(sizes), dtype=torch.int32, device=dev)
    for order in ORDERS:
        r = res if order == "bn_add_relu" else None
        got = segsum.relu_bn_cuda(x, count, _seg(dev, sizes, cap),
                                  order=order, residual=r)
        start = 0
        for n in sizes:
            one, r1 = torch.zeros((1024, C), device=dev), None
            one[:n] = x[start:start + n]
            if r is not None:
                r1 = torch.zeros((1024, C), device=dev)
                r1[:n] = r[start:start + n]
            cnt = torch.tensor(n, dtype=torch.int32, device=dev)
            y1 = segsum.relu_bn_cuda(one, cnt, None, order=order,
                                     residual=r1)
            assert _same(got[start:start + n], y1[:n]), order
            start += n


@pytest.mark.cuda
def test_published_minkunet_graph_session_fuses_every_layer(dev):
    """A graph session of ``minkunet(cr=0.25)``: every body run fuses all
    49 layers (26 bn_relu, 7 bn, 16 bn_add_relu), none runs the chain;
    the logits bitwise an eager forward through the chain."""
    net = pc.minkunet(cr=0.25)
    sb, clouds = _outdoor(dev, 4)
    s = compile_network(net, sb[0].layout, batch=2, device=dev)
    st = SparseTensor.from_point_clouds(clouds, s.layout, device=dev)
    pc.reset_epilogue_calls()
    out = s(st)
    runs = pc.fused_epilogue_count() // len(net.specs)
    assert runs >= 1 and pc.chain_epilogue_count() == 0
    assert pc.fused_epilogue_count() == runs * len(net.specs)
    assert {o: pc.EPILOGUE_CALLS[o] for o in segsum.NORM_ORDERS} == {
        "relu_bn": 0, **{o: runs * n for o, n in ORDERS.items()}}
    stp = st.pad_to(s._bucket(st.capacity))
    plan = s.plan(stp)
    pc.reset_epilogue_calls()
    with torch.enable_grad():
        ref = pc.pointcloud_forward(s.params, s.net, plan, stp.features,
                                    layout=s.layout, segment=s.segment)
    assert pc.chain_epilogue_count() == len(net.specs)
    torch.cuda.synchronize()
    n = int(out.count)
    assert n > 0 and _same(out.features[:n], ref.detach()[:n])
