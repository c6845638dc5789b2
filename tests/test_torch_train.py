"""Training on the port, on the CPU: loss and parameter gradients against
the JAX package's (same scenes, weights converted with ``params_from_jax``),
and the trainer's contracts as the reference states them — the loss falls
and the session serves the new weights, labels survive sort/dedup, the
backward adds no kernel-map search, ``compile_count`` counts buckets,
gradients are bitwise equal under zero extension, and a net with coarse
logits is refused.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SparseTensor as JST
from repro.data import scenes as jscenes
from repro.models import pointcloud as jpc
from repro.train import pointcloud as jtr

from repro_torch.convert import params_from_jax
from repro_torch.core.network_plan import build_network_plan
from repro_torch.core.packing import BitLayout
from repro_torch.core.zdelta import reset_search_calls, search_call_count
from repro_torch.data import scenes
from repro_torch.models import pointcloud as tpc
from repro_torch.serve import compile_network
from repro_torch.train import pointcloud as ttr

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

CPU = "cpu"
EXTENT = (32, 28, 16)
N_CLASSES = 6


def _tl(jl) -> BitLayout:
    return BitLayout(**dataclasses.asdict(jl))


def _setup(batch=2, seed=0, depth=3, width=8):
    sb = scenes.scene_batch(seed=seed, batch=batch, kind="indoor",
                            extent=EXTENT, labels=True, n_classes=N_CLASSES)
    net = tpc.tiny_segnet(in_channels=4, n_classes=N_CLASSES, width=width,
                          depth=depth)
    session = compile_network(net, sb[0].layout, batch=batch, device=CPU)
    st, lab = ttr.labeled_batch(sb, session.layout, device=CPU)
    return sb, net, session, st, lab


def _grads(loss_fn, model, *args):
    named = dict(model.named_parameters())
    loss, acc = loss_fn(model, *args)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss, acc, dict(zip(named, grads))


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_loss_and_grads_match_jax():
    """tiny_segnet on a batch of 2 through plan → forward → masked CE →
    backward in both packages, same scenes and weights: loss within 1e-4
    relative, accuracy within 1e-4, every parameter gradient within 1e-4
    of that tensor's largest entry (fp32 rounding differs between the
    libraries). MinkUNet-42 has its own file
    (test_torch_train_minkunet.py)."""
    tol = 1e-4
    make = lambda m: m.tiny_segnet(in_channels=4, n_classes=8, width=16,
                                   depth=4)
    sb = jscenes.scene_batch(seed=1, batch=2, kind="indoor", extent=EXTENT,
                             labels=True, n_classes=8, overlap=0.5)
    jnet, tnet = make(jpc), make(tpc)
    jl = sb[0].layout.with_batch(2)
    jst, jlab = jtr.labeled_batch(sb, jl)
    cap = 1 << int(np.ceil(np.log2(jst.capacity)))
    jst = jst.pad_to(cap)
    jlab = jnp.concatenate([jlab, jnp.full((cap - jlab.shape[0],), -1,
                                           jlab.dtype)])
    jparams = jpc.init_pointcloud(jax.random.key(0), jnet)
    jloss = jtr.make_segmentation_loss_fn(jnet, jl)
    (jl_val, jacc), jg = jax.value_and_grad(jloss, has_aux=True)(
        jparams, jst.packed, jst.features, jlab)

    tst, tlab = ttr.labeled_batch(sb, _tl(jl), capacity=cap, device=CPU)
    np.testing.assert_array_equal(tst.packed.numpy(), np.asarray(jst.packed))
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tnet,
                            device=CPU)
    tloss = ttr.make_segmentation_loss_fn(tnet, _tl(jl), engine="zdelta")
    loss, acc, grads = _grads(tloss, model, tst.packed, tst.features, tlab)
    want = dict(params_from_jax(jax.tree.map(np.asarray, jg), tnet,
                                device=CPU).named_parameters())
    assert abs(float(loss) - float(jl_val)) <= tol * abs(float(jl_val))
    assert abs(float(acc) - float(jacc)) <= tol
    assert set(want) == set(grads)
    for k, g in grads.items():
        r = want[k].detach().numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=k)


def test_scene_features_and_labels_match_jax():
    sb = jscenes.scene_batch(seed=3, batch=2, kind="indoor", extent=EXTENT,
                             labels=True, n_classes=N_CLASSES)
    for sc in sb:
        np.testing.assert_array_equal(ttr.scene_features(sc, 5),
                                      jtr.scene_features(sc, 5))
    jl = sb[0].layout.with_batch(2)
    jst, jlab = jtr.labeled_batch(sb, jl)
    tst, tlab = ttr.labeled_batch(sb, _tl(jl), device=CPU)
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(tst.features.numpy(),
                                  np.asarray(jst.features))


def test_segmentation_loss_matches_jax_single_scene():
    """``seg=None`` (one segment over the buffer here, ``jnp.sum`` there)
    and a batch with no supervised row (an exact 0, finite gradients)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(300, 5)).astype(np.float32)
    labels = rng.integers(-1, 5, 300).astype(np.int32)
    jl, ja = jtr.segmentation_loss(jnp.asarray(logits), jnp.asarray(labels))
    tx = torch.from_numpy(logits).requires_grad_()
    tl_, ta = ttr.segmentation_loss(tx, torch.from_numpy(labels))
    assert abs(float(tl_) - float(jl)) <= 1e-6 * abs(float(jl))
    assert float(ta) == pytest.approx(float(ja), abs=1e-7)
    z, za = ttr.segmentation_loss(tx, torch.full((300,), -1,
                                                 dtype=torch.int32))
    g, = torch.autograd.grad(z, tx)
    assert float(z) == 0.0 and float(za) == 0.0 and not g.any()


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_train_step_reduces_loss_and_serves():
    _, _, session, st, lab = _setup()
    before = session(st).features.clone()
    trainer = session.compile_train(ttr.PointCloudTrainConfig())
    m0 = trainer.step(st, lab)
    for _ in range(24):
        m = trainer.step(st, lab)
    assert m["loss"] < m0["loss"], (m0, m)
    assert m["accuracy"] > m0["accuracy"]
    assert set(m) == {"loss", "accuracy", "grad_norm", "lr"}
    # the session serves the trained parameters (updated in place)
    out = session(st)
    n = int(out.count)
    assert bool(torch.isfinite(out.features[:n]).all())
    assert not torch.equal(out.features, before)
    assert trainer.opt_state.step == 25
    assert "train/step" in session.metrics.snapshot()["histograms"]


def test_labels_survive_sort_dedup():
    _, _, session, st, lab = _setup()
    coords, _ = st.coords()
    want = scenes.semantic_labels(coords, EXTENT, N_CLASSES)
    n = int(st.count)
    np.testing.assert_array_equal(lab.numpy()[:n], want)
    assert (lab.numpy()[n:] == -1).all()


def test_shuffled_cloud_same_labels():
    sc = scenes.scene_batch(seed=3, batch=1, kind="indoor", extent=EXTENT,
                            labels=True, n_classes=N_CLASSES)[0]
    feats = ttr.scene_features(sc)
    perm = np.random.default_rng(0).permutation(len(sc.coords))
    st_a, lab_a = ttr.labeled_tensor([(sc.coords, feats, sc.labels)],
                                     sc.layout, device=CPU)
    st_b, lab_b = ttr.labeled_tensor(
        [(sc.coords[perm], feats[perm], sc.labels[perm])], sc.layout,
        device=CPU)
    assert torch.equal(st_a.packed, st_b.packed)
    assert torch.equal(lab_a, lab_b)
    assert torch.equal(st_a.features, st_b.features)
    with pytest.raises(ValueError, match="negative"):
        ttr.labeled_tensor([(sc.coords, feats, sc.labels)], sc.layout,
                           ignore_label=0, device=CPU)


def test_backward_adds_zero_searches():
    """A whole step (plan, forward, loss, backward, update) runs exactly
    the kernel-map searches of one inference plan: the backward runs over
    transposed maps, built by a scatter."""
    _, net, session, st, lab = _setup(depth=2)
    stp = st.pad_to(session._bucket(st.capacity))
    reset_search_calls()
    build_network_plan(stp.packed, specs=net.conv_specs(),
                       layout=session.layout, engine=session.engine)
    n_plan = search_call_count()
    assert n_plan > 0
    trainer = session.compile_train()
    reset_search_calls()
    trainer.step(st, lab)
    assert search_call_count() == n_plan


def test_trainer_bucket_count():
    """Two sizes in one pow2 bucket count once; a third size in a new
    bucket counts again."""
    sb, net, session, st, lab = _setup()
    trainer = session.compile_train()
    trainer.step(st, lab)
    assert trainer.compile_count == 1
    small = scenes.scene_batch(seed=9, batch=2, kind="indoor", extent=EXTENT,
                               labels=True, n_classes=N_CLASSES)
    st2, lab2 = ttr.labeled_batch(small, session.layout, device=CPU)
    assert session._bucket(st2.capacity) == session._bucket(st.capacity)
    trainer.step(st2, lab2)
    assert trainer.compile_count == 1
    big = st.pad_to(2 * session._bucket(st.capacity))
    trainer.step(big, torch.cat([lab, torch.full(
        (big.capacity - lab.shape[0],), -1, dtype=torch.int32)]))
    assert trainer.compile_count == 2
    assert "buckets=2" in repr(trainer)


@pytest.mark.parametrize("batch", [1, 2])
def test_grads_zero_extension_invariant(batch):
    """Padding the input to a larger capacity bucket changes no parameter
    gradient by an ulp: every reduction over the capacity axis (BN and
    loss segment sums, dW panels, bias and head) has a fixed grouping.
    ``batch=1`` takes the single-scene loss path, 2 the per-scene one."""
    sb = scenes.scene_batch(seed=5, batch=batch, kind="indoor",
                            extent=EXTENT, labels=True, n_classes=N_CLASSES)
    net = tpc.tiny_segnet(in_channels=4, n_classes=N_CLASSES, width=8,
                          depth=2)
    layout = sb[0].layout.with_batch(batch) if batch > 1 else sb[0].layout
    st, lab = ttr.labeled_batch(sb, layout, device=CPU)
    model = tpc.init_pointcloud(net, seed=0, device=CPU)
    loss_fn = ttr.make_segmentation_loss_fn(net, layout)

    def grads_at(cap):
        stp = st.pad_to(cap)
        labp = torch.cat([lab, torch.full((cap - lab.shape[0],), -1,
                                          dtype=torch.int32)])
        return _grads(loss_fn, model, stp.packed, stp.features, labp)

    cap0 = -(-st.capacity // 128) * 128
    la, _, ga = grads_at(cap0)
    lb, _, gb = grads_at(4 * cap0)
    assert torch.equal(la, lb)
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k


def test_train_rejects_coarse_output_net():
    sb = scenes.scene_batch(seed=0, batch=1, kind="indoor", extent=EXTENT,
                            labels=True)
    net = tpc.centerpoint_large()                 # ends at level 3
    with pytest.raises(ValueError, match="per-voxel labels"):
        ttr.make_pointcloud_train_step(net, sb[0].layout,
                                       ttr.PointCloudTrainConfig())
    s = compile_network(net, sb[0].layout, device=CPU)
    with pytest.raises(ValueError, match="per-voxel labels"):
        s.compile_train()
    with pytest.raises(ValueError, match="negative"):
        ttr.PointCloudTrainConfig(ignore_label=255)


def test_trainer_rejects_misaligned_inputs():
    sb, _, session, st, lab = _setup()
    trainer = session.compile_train()
    with pytest.raises(ValueError, match="labels rows"):
        trainer.step(st, lab[:-1])
    other = scenes.scene_batch(seed=0, batch=1, kind="indoor",
                               extent=EXTENT, labels=True)
    st1, lab1 = ttr.labeled_batch(other, other[0].layout, device=CPU)
    with pytest.raises(ValueError, match="layout"):
        trainer.step(st1, lab1)


def test_scene_pool_matches_jax():
    sb = jscenes.scene_batch(seed=2, batch=2, kind="indoor", extent=EXTENT)
    rng = np.random.default_rng(1)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), 3))
               .astype(np.float32)) for sc in sb]
    jl = sb[0].layout.with_batch(2)
    jst = JST.from_point_clouds(clouds, jl)
    from repro_torch.core.sparse_tensor import SparseTensor
    tst = SparseTensor.from_point_clouds(clouds, _tl(jl), device=CPU)
    for mode in ("mean", "sum"):
        ref = np.asarray(jtr.scene_pool(jst, mode=mode))
        got = ttr.scene_pool(tst, mode=mode).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        ttr.scene_pool(tst, mode="max")
