"""The published MinkUNet of SPVNAS (``models.pointcloud.minkunet``) on the
port's CPU path, against the benchmark's plain reference
(``perfbench/lib/reference.py`` with ``perfbench/configs/pub-minkunet42.py``)
at ``cr = 0.25`` on small outdoor sweeps, two a batch: every map kind
(K = 2 strided, transposed, 1x1 identity, K = 3) pair for pair on the
``zdelta`` engine and the superwindow engine's CPU path, the logits within
the float32 reference's own rounding of the float64 one, one training
step's gradients alike (dF through K = 2 and transposed maps), the
harness's layer check, the epilogue's chain in every order, the graph
fields, and a whole small run of the cell. The four older constructors'
logits are bitwise those of the name-based skips they had before their
graph moved into fields. Imports no JAX.
"""
import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.lib import harness, inputs, reference, scenes, system
from repro_torch.core import network_plan
from repro_torch.core.kernel_map import l1_norm_max, transpose_kernel_map
from repro_torch.core.packing import BitLayout, offset_grid
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.spconv import SpConvSpec, spconv_features
from repro_torch.models import pointcloud as pc
from repro_torch.serve import compile_network

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG_FILE = ROOT / "perfbench" / "configs" / "pub-minkunet42.json"
ARCH = harness.load_module(CFG_FILE.with_suffix(".py"))
CR = 0.25
EXTENT = [96, 96, 24]


def _cfg(cr=CR, engine="zdelta"):
    cfg = json.loads(CFG_FILE.read_text())
    cfg.update(kwargs=dict(cfg["kwargs"], cr=cr), engine=engine,
               widths=[int(cr * c) for c in cfg["widths"]])
    return cfg


@pytest.fixture
def outdoor(monkeypatch):
    """Two outdoor sweeps with two objects on a 96 x 96 x 24 extent: ~4,400
    voxels at level 0, ~80 at level 4."""
    monkeypatch.setitem(scenes.KINDS, "outdoor", functools.partial(
        scenes.outdoor_scene, n_objects=2))
    mix = json.loads((ROOT / "perfbench" / "mixes" / "outdoor-b2.json")
                     .read_text())
    return dict(mix, extent=EXTENT, pool=1)


def _session(cfg, mix, seed=5):
    layers = ARCH.layers(cfg)
    (batch,) = inputs.pool(seed, mix, cfg)
    w = inputs.weights(layers, cfg, seed, "cpu")
    net = system.network(cfg, layers)
    sess = system.session(cfg, net, system.model(net, w), mix["extent"], 2,
                          "cpu")
    return layers, batch, w, sess


# ---------------------------------------------------------------------------
# the constructor and its graph
# ---------------------------------------------------------------------------

def test_the_published_layers_widths_and_graph():
    net = pc.NETWORKS["minkunet"]()
    assert net.name == "minkunet" and len(net.specs) == 49
    assert sum(s.K >= 2 for s in net.specs) == 42
    assert sum(s.K == 1 for s in net.specs) == 7
    assert not any(s.bias for s in net.specs)
    assert {s.K for s in net.specs} == {1, 2, 3}
    ups = [s for s in net.specs if s.transposed]
    assert [(s.K, s.m_in, s.m_out) for s in ups] == [
        (2, 4, 3), (2, 3, 2), (2, 2, 1), (2, 1, 0)]
    downs = [s for s in net.specs if s.K == 2 and not s.transposed]
    assert [(s.m_in, s.m_out) for s in downs] == [(0, 1), (1, 2), (2, 3),
                                                 (3, 4)]
    # the widths after each stage: cs = 32, 32, 64, 128, 256, 256, 128, 96, 96
    stage_out = [s.cout for s, g in zip(net.specs, net.graph)
                 if s.name == "stem1" or s.name.endswith("_b1b")]
    assert stage_out == list(pc.MINKUNET_WIDTHS)
    assert net.specs[-1].cout == 96 and net.n_classes == 19
    orders = [g.order for g in net.graph]
    assert {o: orders.count(o) for o in set(orders)} == {
        "bn_relu": 26, "bn": 7, "bn_add_relu": 16}
    # the decoder's first blocks read the encoder's output of their level
    concat = {s.name: g.concat for s, g in zip(net.specs, net.graph)
              if g.concat}
    assert concat == {f"dec{j}_{p}": f"x{4 - j}" for j in range(1, 5)
                      for p in ("proj", "b0a")}


def test_the_configs_reference_is_the_constructor_field_for_field():
    """``perfbench/configs/pub-minkunet42.py`` states the same graph as the
    port's fields, layer by layer; the harness accepts the net at cr = 1
    and refuses it against another width."""
    for cr in (1.0, CR):
        cfg = _cfg(cr)
        layers = ARCH.layers(cfg)
        net = system.network(cfg, layers)
        for L, s, g in zip(layers, net.specs, net.graph):
            assert (L.src, L.concat, L.save, L.norm, L.add, L.transposed,
                    L.bias) == (g.src, g.concat, g.save, g.norm, g.add,
                                s.transposed, s.bias), L.name
    with pytest.raises(RuntimeError, match="layer"):
        system.network(dict(_cfg(1.0), kwargs=dict(_cfg(1.0)["kwargs"],
                                                   cr=0.5)),
                       ARCH.layers(_cfg(1.0)))


def test_a_graph_must_read_what_an_earlier_layer_saved():
    spec = SpConvSpec("a", 4, 4)
    with pytest.raises(ValueError, match="saved by no earlier layer"):
        pc.PointCloudNet("n", (dataclasses.replace(spec, bias=False),), 4, 2,
                         (pc.LayerGraph(norm="bn", add="r"),))
    with pytest.raises(ValueError, match="norm"):
        pc.LayerGraph(norm="relu")
    with pytest.raises(ValueError, match="graph entries"):
        pc.PointCloudNet("n", (spec, spec), 4, 2, (pc.LayerGraph(),))
    assert pc.PointCloudNet("n", (spec,), 4, 2).graph == (pc.LayerGraph(),)
    assert pc.LayerGraph(norm="bn", add="r").order == "bn_add_relu"
    # a residual join follows a bare standardisation, a bias a relu_bn
    # norm: every layer has an order of the fused epilogue
    for norm in ("relu_bn", "bn_relu"):
        with pytest.raises(ValueError, match="residual join"):
            pc.LayerGraph(norm=norm, add="r")
    for norm in ("bn_relu", "bn"):
        with pytest.raises(ValueError, match="bias"):
            pc.PointCloudNet("n", (spec,), 4, 2, (pc.LayerGraph(norm=norm),))


# ---------------------------------------------------------------------------
# maps
# ---------------------------------------------------------------------------

def test_k2_and_1x1_offset_grids():
    assert offset_grid(2, 4).tolist() == [
        [x, y, z] for x in (0, 4) for y in (0, 4) for z in (0, 4)]
    assert offset_grid(1, 8).tolist() == [[0, 0, 0]]
    assert l1_norm_max(2, 4) == 12 and l1_norm_max(1, 2) == 0
    assert l1_norm_max(3, 2) == 6 and l1_norm_max(5, 1) == 6


def test_transpose_without_the_mirror_keeps_each_column():
    g = torch.Generator().manual_seed(3)
    n_in, M, kd = 37, 20, 8
    m = torch.full((M, kd), -1, dtype=torch.int32)
    for k in range(kd):     # injective columns
        rows = torch.randperm(M, generator=g)[:12]
        m[rows, k] = torch.randperm(n_in, generator=g)[:12].to(torch.int32)
    mt = transpose_kernel_map(m, n_in=n_in, mirror=False)
    want = torch.full((n_in, kd), -1, dtype=torch.int32)
    for i in range(M):
        for k in range(kd):
            if m[i, k] >= 0:
                want[m[i, k], k] = i
    assert torch.equal(mt, want)
    assert torch.equal(transpose_kernel_map(m, n_in=n_in),
                       want.flip(1))


@pytest.mark.parametrize("engine", ["zdelta", "zdelta_cuda"])
def test_every_map_kind_equals_the_references_pairs(engine, outdoor):
    cfg = _cfg(engine=engine)
    layers, batch, _, sess = _session(cfg, outdoor)
    network_plan.reset_plan_map_counts()
    plan = sess.plan(system.pack(sess, batch))
    assert network_plan.plan_map_counts() == {
        "searched": 38, "transposed": 4, "identity": 7}
    ref = reference.build_plan(batch.coords, layers, "cpu")
    kinds = set()
    for L in layers:
        m = plan.kmaps[L.name].m
        cols = reference.layer_cols(ref, L)
        assert m.shape[1] == len(cols) == L.K ** 3
        for k, (rows, src) in enumerate(cols):
            i = torch.nonzero(m[:, k] >= 0).flatten()
            assert torch.equal(i, rows), (L.name, k)
            assert torch.equal(m[i, k].long(), src), (L.name, k)
        kinds.add((L.K, L.transposed, L.m_in == L.m_out))
    assert kinds == {(3, False, True), (2, False, False), (2, True, False),
                     (1, False, True)}
    # a transposed map holds one input a valid output row, a K = 2 strided
    # map each input row once
    for L in layers:
        valid = plan.kmaps[L.name].m >= 0
        if L.transposed:
            n = int(plan.coords[L.m_out].count)
            assert bool((valid[:n].sum(1) == 1).all())
        elif L.K == 2:
            assert int(valid.sum()) == int(plan.coords[L.m_in].count)


def test_a_transposed_layer_without_its_strided_twin_searches_it(outdoor):
    """The plan reuses a strided layer's map where the network has one and
    searches it otherwise; the map is the same."""
    cfg = _cfg()
    layers, batch, _, sess = _session(cfg, outdoor)
    st = system.pack(sess, batch)
    stp = st.pad_to(sess._bucket(st.capacity))
    up = next(s for s in sess.net.specs if s.transposed)
    lone = dataclasses.replace(up, name="up")
    network_plan.reset_plan_map_counts()
    alone = network_plan.build_network_plan(
        stp.packed, specs=(lone,), layout=sess.layout, engine="zdelta")
    assert network_plan.plan_map_counts() == {
        "searched": 1, "transposed": 1, "identity": 0}
    assert torch.equal(alone.kmaps["up"].m, sess.plan(st).kmaps[up.name].m)
    with pytest.raises(ValueError, match="coarser level to a finer"):
        network_plan.build_network_plan(
            stp.packed, specs=(dataclasses.replace(lone, m_in=0, m_out=1),),
            layout=sess.layout, engine="zdelta")


def test_the_sequential_baseline_builds_every_kind(outdoor):
    cfg = _cfg()
    layers, batch, _, sess = _session(cfg, outdoor)
    st = system.pack(sess, batch)
    stp = st.pad_to(sess._bucket(st.capacity))
    plan = sess.plan(st)
    sort_fn, level_fns, map_fns = network_plan.sequential_plan_fns(
        sess.net.specs, sess.layout)
    v0 = sort_fn(stp.packed)
    coords = {0: v0, **{m: f(v0) for m, f in level_fns.items()}}
    network_plan.reset_plan_map_counts()
    for s in sess.net.specs:
        got = map_fns[s.name](coords[s.m_in], coords[s.m_out]).m
        assert torch.equal(got, plan.kmaps[s.name].m), s.name
    # a yardstick: the plan's map counters see none of its maps
    assert network_plan.plan_map_counts() == {
        "searched": 0, "transposed": 0, "identity": 0}


# ---------------------------------------------------------------------------
# logits and gradients against the reference
# ---------------------------------------------------------------------------

def _gap(a, ref):
    return float((a.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("engine", ["zdelta", "zdelta_cuda"])
def test_logits_match_the_reference(engine, outdoor):
    """The port's fp32 logits lie within 10x the float32 reference's own
    distance from the float64 reference (seeded weights)."""
    cfg = _cfg(engine=engine)
    layers, batch, w, sess = _session(cfg, outdoor)
    pc.reset_epilogue_calls()
    out, health = sess.run_with_health(system.pack(sess, batch))
    assert health.ok
    assert pc.chain_epilogue_count() == len(layers)
    ref = reference.build_plan(batch.coords, layers, "cpu")
    f64 = reference.forward(
        ref, layers, reference.input_rows(ref, batch.feats, "cpu",
                                          torch.float64),
        {k: v.double() for k, v in w.items()})
    f32 = reference.forward(
        ref, layers, reference.input_rows(ref, batch.feats, "cpu",
                                          torch.float32), w)
    n = int(out.count)
    assert n == f64.shape[0]
    assert _gap(out.features[:n], f64) <= 10 * _gap(f32, f64) + 1e-6


def test_one_training_step_matches_the_references_gradients(outdoor):
    """The masked cross-entropy's gradient of every leaf through the port's
    backward (dF over K = 2 strided, transposed and 1x1 maps, the chain of
    every norm order, the residual joins) against the float64 reference's:
    the mean over leaves of the relative gap within 3x the float32
    reference's own."""
    cfg = _cfg()
    layers, batch, w, sess = _session(cfg, outdoor)
    st = system.pack(sess, batch)
    stp = st.pad_to(sess._bucket(st.capacity))
    plan = sess.plan(st)
    ref = reference.build_plan(batch.coords, layers, "cpu")
    labels = reference.input_rows(
        ref, [scenes.labels(c, EXTENT, 19) for c in batch.coords], "cpu",
        None).long()

    def grads(dtype):
        leaves = {k: v.detach().to(dtype).requires_grad_(True)
                  for k, v in w.items()}
        with torch.enable_grad():
            loss = reference.segmentation_loss(reference.forward(
                ref, layers, reference.input_rows(ref, batch.feats, "cpu",
                                                  dtype), leaves), labels)
            g = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, g))

    g64, g32 = grads(torch.float64), grads(torch.float32)
    model = system.model(sess.net, w)
    n = int(plan.coords[0].count)
    with torch.enable_grad():
        loss = reference.segmentation_loss(pc.pointcloud_forward(
            model, sess.net, plan, stp.features, layout=sess.layout)[:n],
            labels)
        named = dict(model.named_parameters())
        gp = dict(zip(named, torch.autograd.grad(loss,
                                                 list(named.values()))))
    assert set(gp) == set(g64)

    def mean_gap(g):
        return np.mean([float((g[k].double() - g64[k]).norm()
                              / g64[k].norm()) for k in g64])
    assert mean_gap(gp) <= 3 * mean_gap(g32) + 1e-6, (mean_gap(gp),
                                                      mean_gap(g32))


# ---------------------------------------------------------------------------
# the epilogue's chain in each order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ["bn_relu", "bn", "bn_add_relu"])
def test_the_chain_of_each_order_is_the_composed_chain(order):
    """On the CPU every order runs the chain: bitwise the standardisation
    composed by hand with the ReLU and the residual add, gradients too."""
    g = torch.Generator().manual_seed(1)
    cap, C = 300, 6
    count = torch.tensor(230, dtype=torch.int32)
    seg = (torch.tensor([0] * 100 + [1] * 130 + [2] * 70, dtype=torch.int32),
           torch.tensor([0, 100], dtype=torch.int32),
           torch.tensor([100, 130], dtype=torch.int32), 2)
    x = torch.randn((cap, C), generator=g)
    r = torch.randn((cap, C), generator=g)
    spec = SpConvSpec("l", 3, C, bias=False)

    def run(composed):
        xv, rv = x.clone().requires_grad_(True), r.clone().requires_grad_(True)
        res = rv if order == "bn_add_relu" else None
        if composed:
            y = pc._bn(xv, count, seg)
            y = (torch.relu(y) if order == "bn_relu" else
                 torch.relu(y + rv) if res is not None else y)
        else:
            pc.reset_epilogue_calls()
            y = pc._conv_epilogue(xv, None, spec, count, seg, order=order,
                                  residual=res)
            assert pc.chain_epilogue_count() == 1
            assert pc.EPILOGUE_CALLS[order] == 0
        leaves = [xv] + ([rv] if res is not None else [])
        return y.detach(), torch.autograd.grad((y * y).sum(), leaves)

    (ya, ga), (yb, gb) = run(False), run(True)
    assert torch.equal(ya, yb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
    # rows outside every scene: +0, or the residual's ReLU
    pad = torch.relu(r[230:]) if order == "bn_add_relu" else 0
    assert bool((ya[230:] == pad).all())


# ---------------------------------------------------------------------------
# the older constructors: their skips moved from layer names into fields
# ---------------------------------------------------------------------------

def _name_skips_forward(params, net, plan, features, layout):
    """The feature pass as it read its skips from layer names before the
    graph moved into fields: encoder outputs stashed per level, appended
    at ``dec*_a``."""
    segs = pc.level_segments(plan, layout) if layout.bb else {}
    skips, x = {}, features
    for spec in net.specs:
        kmap = plan.kmaps[spec.name]
        if spec.name.startswith("dec") and spec.name.endswith("_a"):
            skip = skips.get(spec.m_in)
            if skip is not None:
                x = torch.cat([x, skip], dim=-1)
        layer = params.layers[spec.name]
        bias = None if layer.bias is None else layer.bias.to(x.dtype)
        x = pc._conv_epilogue(spconv_features(layer, spec, x, kmap), bias,
                              spec, kmap.out_count, segs.get(spec.m_out))
        if spec.name.startswith("enc") and spec.name.endswith("_b"):
            skips[spec.m_out] = x
        if spec.name.startswith("stem"):
            skips[0] = x
    return pc.rowdot_matmul(x, params.head.to(x.dtype),
                            backend=net.specs[-1].backend)


@pytest.mark.parametrize("name,kw", [
    ("tiny_segnet", dict(width=8, depth=3)),
    ("minkunet42", dict(width=(8, 8, 8, 8))),
    ("centerpoint_large", dict(width=(4, 8, 8, 8))),
    ("sparse_resnet21", dict(width=(4, 8, 8, 8)))])
def test_older_networks_are_bitwise_their_name_based_skips(name, kw,
                                                          outdoor):
    ch = 5 if name == "centerpoint_large" else 4
    net = getattr(pc, name)(in_channels=ch, n_classes=5, **kw)
    (batch,) = inputs.pool(3, outdoor, {"in_channels": ch})
    s = compile_network(net, BitLayout.for_extent(*EXTENT), batch=2,
                        device="cpu", engine="zdelta")
    st = SparseTensor.from_point_clouds(list(zip(batch.coords, batch.feats)),
                                        s.layout, device="cpu")
    stp = st.pad_to(s._bucket(st.capacity))
    with torch.no_grad():
        plan = s.plan(st)
        got = pc.pointcloud_forward(s.params, net, plan, stp.features,
                                    layout=s.layout)
        want = _name_skips_forward(s.params, net, plan, stp.features,
                                   s.layout)
    assert torch.equal(got, want)
    if name == "minkunet42":
        assert [g.concat for g in net.graph if g.concat] == [
            "l3", "l2", "l1", "l0"]


# ---------------------------------------------------------------------------
# the benchmark's new reader and a whole small run of the cell
# ---------------------------------------------------------------------------

def test_the_epilogue_reader_sums_the_epilogues_kernels():
    mod = harness.load_module(ROOT / "perfbench" / "metrics"
                              / "epilogue_ms.infer.py")
    ns = "void (anonymous namespace)::"
    ops = [(ns + "chunk_partials<(anonymous namespace)::ZRows>(int)", 0,
            1_000_000),
           (ns + "bn_add_relu_apply<4>(float const*)", 0, 2_000_000),
           (ns + "relu_bn_apply<1>(float const*)", 0, 500_000),
           (ns + "combine_partials(float const*)", 0, 250_000),
           (ns + "chunk_offsets(int const*)", 0, 250_000),
           (ns + "chunk_partials<(anonymous namespace)::RawRows<float> >()",
            0, 7_000_000),
           (ns + "os_mma_kernel<float, 64>(float const*)", 0, 9_000_000),
           ("void at::native::vectorized_elementwise_kernel<4>()", 0,
            3_000_000)]

    @dataclasses.dataclass
    class Ctx:
        trace: object = None
        kind: str = "closed"
        calls: int = 2

    assert mod.read(Ctx()) is None
    tr = type("T", (), {"ops": ops})()
    assert mod.read(Ctx(trace=tr)) == pytest.approx(2.0)
    assert mod.read(Ctx(trace=type("T", (), {"ops": ops[5:]})())) is None
    assert mod.read(Ctx(trace=tr, kind="train")) is None


def test_a_small_run_of_the_cell_is_correct(tmp_path, monkeypatch):
    from perfbench.tests.helpers import (few_objects, no_import_check,
                                         small_tree)
    few_objects(monkeypatch, 2)
    no_import_check(monkeypatch)
    cfg = _cfg()
    man, bench = small_tree(
        tmp_path, widths={"pub-minkunet42": {
            "kwargs": cfg["kwargs"], "widths": cfg["widths"],
            "engine": "zdelta"}},
        limits={"logit_gap": 1e-2},
        mix_over={"pool": 2, "warmup_rounds": 1, "sample_within": 1,
                  "extent": EXTENT})
    r = harness.run("minkunet42-outdoor-b4", 2 ** 31 + 11, 0.01, False,
                    started=0.0, device="cpu", manifest=man, bench=bench)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["logit_gap"]["value"] < 1e-4
