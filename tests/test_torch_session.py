"""The port's front door end to end on the CPU: session logits against the
JAX session with the same (converted) weights, and the port's own
contracts — batch of 2 bitwise equal to two single runs, one compiled key
per bucket, actionable errors.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import SparseTensor as JST
from repro.data import scenes as jscenes
from repro.models import pointcloud as jpc
from repro.serve import compile_network as j_compile

from repro_torch.convert import params_from_jax
from repro_torch.core.packing import BitLayout
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.models import pointcloud as tpc
from repro_torch.serve import compile_network

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)


CPU = "cpu"


def _clouds(B=2, seed=7, extent=(48, 40, 24)):
    batch = jscenes.scene_batch(seed=seed, batch=B, kind="indoor",
                                extent=extent, overlap=0.5)
    rng = np.random.default_rng(1)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), 4))
               .astype(np.float32)) for sc in batch]
    return batch[0].layout, clouds


def _tl(jl) -> BitLayout:
    return BitLayout(**dataclasses.asdict(jl))


NETS = {
    "tiny_segnet": lambda m: m.tiny_segnet(in_channels=4, n_classes=5),
    "minkunet42": lambda m: m.minkunet42(width=(8, 8, 8, 8)),
}


@pytest.mark.parametrize("name", list(NETS))
def test_session_logits_match_jax(name):
    """Same scenes, same weights (params_from_jax): logits within
    1e-3 * max|ref| (fp32 rounding differs between the libraries and BN
    over few voxels amplifies it along the depth)."""
    jl, clouds = _clouds()
    jnet, tnet = NETS[name](jpc), NETS[name](tpc)
    jparams = jpc.init_pointcloud(jax.random.key(0), jnet)
    js = j_compile(jnet, jl, params=jparams, batch=2, min_bucket=128)
    jo = js(JST.from_point_clouds(clouds, js.layout))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tnet,
                             device=CPU)
    ts = compile_network(tnet, _tl(jl), params=params, batch=2,
                         min_bucket=128, device=CPU)
    to = ts(SparseTensor.from_point_clouds(clouds, ts.layout, device=CPU))
    n = int(jo.count)
    assert int(to.count) == n
    np.testing.assert_array_equal(to.packed.numpy(), np.asarray(jo.packed))
    ref = np.asarray(jo.features)[:n]
    got = to.features.numpy()[:n]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-3 * float(np.abs(ref).max()))


@pytest.mark.parametrize("engine", ["zdelta", "zdelta_cuda"])
@pytest.mark.parametrize("name", list(NETS))
def test_batch_equals_single_runs_bitwise(engine, name):
    jl, clouds = _clouds(extent=(28, 24, 16))
    net = NETS[name](tpc)
    s = compile_network(net, _tl(jl), batch=2, engine=engine, min_bucket=128,
                        device=CPU)
    out_b = s(SparseTensor.from_point_clouds(clouds, s.layout, device=CPU))
    per_scene = out_b.unbatch()
    for i, cloud in enumerate(clouds):
        o1 = s(SparseTensor.from_point_clouds([cloud], s.layout,
                                              device=CPU)).unbatch()[0]
        n = int(o1.count)
        assert n == int(per_scene[i].count)
        assert torch.equal(per_scene[i].packed[:n], o1.packed[:n])
        assert torch.equal(per_scene[i].features[:n], o1.features[:n]), i


def test_engines_give_identical_logits():
    jl, clouds = _clouds(extent=(28, 24, 16))
    net = tpc.minkunet42(width=(8, 8, 8, 8))
    outs = []
    for engine in ("zdelta", "zdelta_cuda", "zdelta_cuda_window"):
        s = compile_network(net, _tl(jl), batch=2, engine=engine, seed=3,
                            min_bucket=128, device=CPU)
        outs.append(s(SparseTensor.from_point_clouds(clouds, s.layout,
                                                     device=CPU)))
    assert torch.equal(outs[0].features, outs[1].features)
    assert torch.equal(outs[0].features, outs[2].features)


def test_compile_count_is_bucket_count():
    jl, clouds = _clouds(extent=(28, 24, 16))
    s = compile_network(tpc.tiny_segnet(), _tl(jl), batch=2, min_bucket=1024,
                        device=CPU)
    one = SparseTensor.from_point_clouds(clouds[:1], s.layout, device=CPU)
    both = SparseTensor.from_point_clouds(clouds, s.layout, device=CPU)
    s(one)
    s(one)
    assert s.compile_count == 1
    _, health = s.run_with_health(both)
    assert s.compile_count == 2
    assert health.bucket == 8192 and health.ok and health.replans == 0
    assert set(health.window_overflow_cells) == {sp.name for sp in s.net.specs}
    snap = s.metrics.snapshot()
    assert snap["counters"]["session_runs"] == 3
    assert "session/call" in snap["histograms"]
    assert s.num_scenes == 2 and "tiny_segnet" in repr(s)
    plan = s.plan(both)
    assert set(plan.kmaps) == {sp.name for sp in s.net.specs}


def test_session_rejects_what_it_cannot_run():
    jl, clouds = _clouds(extent=(28, 24, 16))
    net = tpc.tiny_segnet()
    s = compile_network(net, _tl(jl), batch=2, device=CPU)
    with pytest.raises(TypeError, match="SparseTensor"):
        s(np.zeros(10))
    with pytest.raises(ValueError, match="layout"):
        s(SparseTensor.from_point_clouds(clouds[:1], _tl(jl), device=CPU))
    c, f = clouds[0]
    with pytest.raises(ValueError, match="channels"):
        s(SparseTensor.from_point_clouds([(c, f[:, :3])], s.layout,
                                         device=CPU))
    with pytest.raises(ValueError, match="tune_sample"):
        compile_network(net, _tl(jl), tuner="measure", device=CPU)
    with pytest.raises(ValueError, match="tuner"):
        compile_network(net, _tl(jl), tuner="fastest", device=CPU)
    # the tuner runs: measure mode on the CPU sweeps the plain versions
    sample = SparseTensor.from_point_clouds(clouds[:1], _tl(jl), device=CPU)
    tuned = compile_network(net, _tl(jl), batch=2, tuner="measure",
                            tune_sample=sample, device=CPU)
    assert all(sp.backend == "torch" for sp in tuned.net.specs)
    assert set(tuned.tune_report.results) == {sp.name for sp in net.specs}
    assert tuned.segment.backend == "torch"
    out = tuned(SparseTensor.from_point_clouds(clouds, tuned.layout,
                                               device=CPU))
    assert bool(torch.isfinite(out.features[:int(out.count)]).all())
    from repro_torch.train import GuardedPointCloudTrainer
    assert isinstance(s.compile_train(guard=True), GuardedPointCloudTrainer)
    with pytest.raises(ValueError, match="resume=True"):
        s.compile_train(resume=True)


def test_net_factories_match_reference():
    for name, fn in tpc.NETWORKS.items():
        a, b = fn(), jpc.NETWORKS[name]()
        assert (a.name, a.in_channels, a.n_classes) == (
            b.name, b.in_channels, b.n_classes)
        assert [(s.name, s.cin, s.cout, s.K, s.m_in, s.m_out, s.dataflow)
                for s in a.specs] == [
            (s.name, s.cin, s.cout, s.K, s.m_in, s.m_out, s.dataflow)
            for s in b.specs]
    assert len(tpc.minkunet42().specs) == 42


def test_params_from_jax_checks_shapes():
    net = tpc.tiny_segnet(in_channels=4, n_classes=5)
    jparams = jax.tree.map(np.asarray, jpc.init_pointcloud(
        jax.random.key(1), jpc.tiny_segnet(in_channels=4, n_classes=5)))
    model = params_from_jax(jparams, net, device=CPU)
    np.testing.assert_array_equal(model.layers["stem"].weight.detach().numpy(),
                                  jparams["stem"]["w"])
    np.testing.assert_array_equal(model.head.detach().numpy(), jparams["head"])
    jparams["sub0"]["w"] = jparams["sub0"]["w"][:, :3]
    with pytest.raises(ValueError, match="sub0"):
        params_from_jax(jparams, net, device=CPU)


def test_init_pointcloud_is_seeded():
    net = tpc.tiny_segnet()
    a = tpc.init_pointcloud(net, seed=5, device=CPU)
    b = tpc.init_pointcloud(net, seed=5, device=CPU)
    c = tpc.init_pointcloud(net, seed=6, device=CPU)
    assert torch.equal(a.head, b.head) and not torch.equal(a.head, c.head)
    assert set(a.layers) == {s.name for s in net.specs}


def test_head_is_chunk_invariant():
    """The head's rows do not depend on how many rows share the call."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3 * tpc.HEAD_ROWS // 2, 16))
                         .astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 5)).astype(np.float32))
    full = tpc.head_matmul(x, w)
    part = tpc.head_matmul(x[:1000], w)
    assert torch.equal(full[:1000], part)
    torch.testing.assert_close(full, x @ w)
