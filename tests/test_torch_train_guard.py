"""The port's self-healing trainer (``repro_torch.train.guard``) on the
CPU: the escalation ladder of ``tests/test_train_guard.py`` mirrored test
for test — non-finite skip (a bitwise no-op), loss-spike skip, per-scene
bisection quarantine, last_good rollback, typed abort, checkpoint cadence
and resume — and the port against the JAX package: the same poisoned
sequence gives equal counters and reports and parameters within the
training parity tolerance, and ``guarded_apply_updates`` raises the same
flags on the same non-finite gradients.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import scenes as jscenes
from repro.models import pointcloud as jpc
from repro.serve import compile_network as j_compile
from repro.train import faults as jfaults
from repro.train import guard as jguard
from repro.train import optimizer as jopt
from repro.train import pointcloud as jtr

from repro_torch.ckpt import CheckpointManager
from repro_torch.convert import params_from_jax
from repro_torch.core.packing import BitLayout
from repro_torch.data import scenes
from repro_torch.models import pointcloud as pc
from repro_torch.serve import compile_network
from repro_torch.train import (AdamWConfig, GuardConfig,
                               GuardedPointCloudTrainer, LossSpikeDetector,
                               PointCloudTrainConfig, PointCloudTrainer,
                               TrainAbortError, init_opt_state,
                               labeled_batch, labeled_tensor,
                               segmentation_loss)
from repro_torch.train import faults as tf
from repro_torch.train.guard import guarded_apply_updates
from repro_torch.train.optimizer import apply_updates
from repro_torch.train.pointcloud import scene_features

torch.set_num_threads(1)

CPU = "cpu"
EXTENT = (32, 28, 16)
N_CLASSES = 6


def _net():
    return pc.tiny_segnet(in_channels=4, n_classes=N_CLASSES, width=8,
                          depth=3)


def _setup(batch=3, seed=0, guard=None, **kw):
    sb = scenes.scene_batch(seed=seed, batch=batch, kind="indoor",
                            extent=EXTENT, labels=True, n_classes=N_CLASSES)
    session = compile_network(_net(), sb[0].layout, batch=batch, device=CPU)
    st, lab = labeled_batch(sb, session.layout, device=CPU)
    trainer = session.compile_train(guard=guard or GuardConfig(), **kw)
    return sb, session, trainer, st, lab


def _bytes(model):
    return [p.detach().numpy().tobytes() for p in model.parameters()]


def _state_bytes(state):
    return ([t.numpy().tobytes() for t in state.mu.values()]
            + [t.numpy().tobytes() for t in state.nu.values()]
            + [state.step])


def _clone_session(session, batch):
    """The same weights in separate tensors (the port updates in place)."""
    return compile_network(session.net, session.layout, batch=batch,
                           params=copy.deepcopy(session.params), device=CPU)


# -- rung 1: non-finite skip is a bitwise no-op -------------------------------

@pytest.mark.parametrize("value", [float("nan"), float("inf")])
def test_nonfinite_batch_is_bitwise_noop(value):
    _, session, tr, st, lab = _setup(batch=1)
    tr.step(st, lab)                      # one clean commit first
    p_bytes = _bytes(session.params)
    o_bytes = _state_bytes(tr.opt_state)
    m = tr.step(tf.poison_nonfinite(st, rows=(0,), value=value), lab)
    assert m["step_ok"] == 0.0
    assert _bytes(session.params) == p_bytes
    assert _state_bytes(tr.opt_state) == o_bytes      # step included
    r = tr.last_report
    assert r.action == "skipped" and r.nonfinite and not r.committed
    assert r.quarantined == [0]
    assert tr.counters["nonfinite_steps"] == 1
    assert tr.counters["steps_skipped"] == 1


def test_guarded_equals_plain_on_clean_batches():
    _, s1, guarded, st, lab = _setup(batch=3)
    s2 = _clone_session(s1, batch=3)
    plain = s2.compile_train()
    assert isinstance(plain, PointCloudTrainer)
    assert not isinstance(plain, GuardedPointCloudTrainer)
    for _ in range(3):
        m_g = guarded.step(st, lab)
        m_p = plain.step(st, lab)
        assert _bytes(s1.params) == _bytes(s2.params)
        assert _state_bytes(guarded.opt_state) == _state_bytes(
            plain.opt_state)
    assert m_g["loss"] == m_p["loss"]
    assert guarded.counters["steps_ok"] == 3
    assert guarded.compile_count == plain.compile_count == 1


# -- rung 2: loss-spike skip --------------------------------------------------

def test_label_poison_trips_spike_detector_not_nan():
    # out-of-range labels are clipped to a wrong-but-finite loss; train the
    # baseline down first so everything-wrong labels cost ~3x its median
    g = GuardConfig(spike_window=6, spike_factor=1.8, spike_min_history=4,
                    bisect=False, rollback_after=100)
    tcfg = PointCloudTrainConfig(opt=AdamWConfig(lr=2e-2, warmup_steps=2,
                                                 total_steps=100))
    sb = scenes.scene_batch(seed=0, batch=2, kind="indoor", extent=EXTENT,
                            labels=True, n_classes=N_CLASSES)
    session = compile_network(_net(), sb[0].layout, batch=2, device=CPU)
    st, lab = labeled_batch(sb, session.layout, device=CPU)
    tr = session.compile_train(tcfg, guard=g)
    for _ in range(15):
        tr.step(st, lab)
    assert tr.last_report.ok
    p_bytes = _bytes(session.params)
    bad_lab = tf.poison_labels(lab, rows=range(int(st.count)), value=10 ** 6)
    m = tr.step(st, bad_lab)
    assert np.isfinite(m["loss"]) and m["step_ok"] == 1.0
    r = tr.last_report
    assert r.spike and not r.nonfinite and r.action == "skipped"
    assert _bytes(session.params) == p_bytes
    assert tr.counters["spikes"] == 1
    m = tr.step(st, lab)
    assert tr.last_report.ok and np.isfinite(m["loss"])


def test_spike_detector_unit():
    d = LossSpikeDetector(window=4, factor=10.0, min_history=3, floor=1e-3)
    assert not d.is_spike(1e9)
    for v in (1.0, 1.1, 0.9):
        d.record(v)
    assert d.is_spike(50.0) and not d.is_spike(5.0)
    for v in (2.0, 2.0, 2.0, 2.0):
        d.record(v)
    assert not d.is_spike(15.0) and d.is_spike(25.0)
    d.reset()
    assert not d.is_spike(1e9)


# -- rung 3: bisection quarantine and the replay equivalence -----------------

def test_bisection_quarantines_poisoned_scene_only():
    _, session, tr, st, lab = _setup(batch=4, seed=2)
    tr.step(st, lab)
    m = tr.step(tf.poison_scene_nonfinite(st, 2), lab)
    assert m["step_ok"] == 0.0
    r = tr.last_report
    assert r.action == "bisected" and r.nonfinite
    assert r.quarantined == [2]
    assert sorted(i for grp in r.committed for i in grp) == [0, 1, 3]
    c = tr.counters
    assert c["bisections"] == 1 and c["scenes_quarantined"] == 1
    assert c["sub_steps_committed"] == len(r.committed)
    for p in session.params.parameters():
        assert bool(torch.isfinite(p).all())


def test_poisoned_run_bitwise_equals_clean_run_on_healthy_work():
    """A guarded run fed NaN-poisoned batches ends with params and state
    bitwise equal to a plain trainer run over exactly the committed work
    (full healthy batches + the recorded bisection sub-batches)."""
    batch = 3
    sb, s1, tr, st, lab = _setup(batch=batch, seed=3)
    s2 = _clone_session(s1, batch=batch)
    poisoned_at = {1: 1, 3: 0}
    reports = []
    for i in range(5):
        x = (tf.poison_scene_nonfinite(st, poisoned_at[i])
             if i in poisoned_at else st)
        tr.step(x, lab)
        reports.append(tr.last_report)
    clean = s2.compile_train()
    clouds = [(sc.coords, scene_features(sc), sc.labels) for sc in sb]
    for r in reports:
        for grp in r.committed:
            if grp is None:
                clean.step(st, lab)
            else:
                sst, slab = labeled_tensor([clouds[i] for i in grp],
                                           s2.layout, device=CPU)
                clean.step(sst, slab)
    assert _bytes(s1.params) == _bytes(s2.params)
    assert _state_bytes(tr.opt_state) == _state_bytes(clean.opt_state)
    assert tr.counters["scenes_quarantined"] == 2
    assert tr.counters["steps_ok"] == 3


# -- rungs 4+5: rollback and typed abort --------------------------------------

def test_rollback_restores_last_good(tmp_path):
    g = GuardConfig(rollback_after=2, bisect=True)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    _, session, tr, st, lab = _setup(batch=1, guard=g, ckpt=mgr)
    ids = [id(p) for p in session.params.parameters()]
    tr.step(st, lab)
    good = tr.save(mark_good=True)
    good_bytes = _bytes(session.params)
    good_state = _state_bytes(tr.opt_state)
    tr.step(st, lab)                      # drift past the anchor
    bad = tf.poison_nonfinite(st, rows=(0,))
    tr.step(bad, lab)
    tr.step(bad, lab)                     # -> rollback
    r = tr.last_report
    assert r.action == "rolled_back" and r.rollback_to == good
    assert _bytes(session.params) == good_bytes
    assert _state_bytes(tr.opt_state) == good_state
    assert tr.opt_state.step == good
    assert [id(p) for p in session.params.parameters()] == ids
    assert tr.counters["rollbacks"] == 1
    tr.step(st, lab)
    assert tr.last_report.ok


def test_abort_without_checkpoint_manager():
    g = GuardConfig(rollback_after=2, bisect=False)
    _, _, tr, st, lab = _setup(batch=1, guard=g)
    bad = tf.poison_nonfinite(st, rows=(0,))
    tr.step(bad, lab)
    with pytest.raises(TrainAbortError) as ei:
        tr.step(bad, lab)
    assert ei.value.report is not None
    assert ei.value.counters["nonfinite_steps"] == 2


def test_abort_after_max_rollbacks(tmp_path):
    g = GuardConfig(rollback_after=1, max_rollbacks=1, bisect=False)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    _, _, tr, st, lab = _setup(batch=1, guard=g, ckpt=mgr)
    tr.step(st, lab)
    tr.save(mark_good=True)
    bad = tf.poison_nonfinite(st, rows=(0,))
    tr.step(bad, lab)
    assert tr.last_report.action == "rolled_back"
    with pytest.raises(TrainAbortError) as ei:
        tr.step(bad, lab)
    assert "max_rollbacks" in str(ei.value)


# -- checkpoint cadence, last_good advancement, resume ------------------------

def test_auto_checkpoint_cadence_and_last_good_lag(tmp_path):
    g = GuardConfig(ckpt_every=2, last_good_after=2)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=10, async_save=False)
    _, _, tr, st, lab = _setup(batch=2, guard=g, ckpt=mgr)
    for _ in range(4):
        tr.step(st, lab)
    mgr.wait()
    assert mgr.complete_steps() == [2, 4]
    assert mgr.last_good_step() == 2
    assert tr.counters["checkpoint_saves"] == 2
    tr.step(st, lab)
    tr.step(st, lab)
    assert mgr.last_good_step() == 4


def test_bad_steps_do_not_advance_last_good(tmp_path):
    g = GuardConfig(ckpt_every=1, last_good_after=2, bisect=False,
                    rollback_after=100)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=10, async_save=False)
    _, _, tr, st, lab = _setup(batch=1, guard=g, ckpt=mgr)
    tr.step(st, lab)                      # save @1, pending
    tr.step(tf.poison_nonfinite(st, rows=(0,)), lab)
    assert mgr.last_good_step() is None
    tr.step(st, lab)                      # save @2 pending
    tr.step(st, lab)
    tr.step(st, lab)
    assert mgr.last_good_step() == 2


def test_resume_walks_past_corrupt_latest(tmp_path):
    """Resume restores the newest VERIFYING checkpoint when the latest is
    corrupt, the counters record the checksum failure, and training goes
    on bitwise on the uninterrupted run's trajectory. Saves are async:
    each snapshot is taken before the next step overwrites the tensors."""
    d = str(tmp_path / "ck")
    g = GuardConfig(ckpt_every=1, last_good_after=1)
    mgr = CheckpointManager(d, keep=10, async_save=True)
    _, s1, tr, st, lab = _setup(batch=2, guard=g, ckpt=mgr)
    p0 = copy.deepcopy(s1.params)
    snap = {}
    for _ in range(3):
        tr.step(st, lab)
        snap[tr.opt_state.step] = _bytes(s1.params)
    mgr.wait()
    tf.corrupt_checkpoint(d, 3, mode="flip")

    s2 = compile_network(s1.net, s1.layout, batch=2, params=p0, device=CPU)
    tr2 = s2.compile_train(guard=True, ckpt=CheckpointManager(
        d, async_save=False), resume=True)
    assert tr2.opt_state.step == 2
    assert _bytes(s2.params) == snap[2]
    assert tr2.counters["checksum_failures"] == 1
    assert tr2.counters["last_good_step"] == 2
    tr2.step(st, lab)
    assert _bytes(s2.params) == snap[3]


def test_resume_empty_directory_is_noop(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    _, _, tr, _, _ = _setup(batch=1, guard=True, ckpt=mgr)
    assert tr.resume() is None
    assert tr.opt_state.step == 0


# -- the zero-supervised-voxel loss -------------------------------------------

def test_segmentation_loss_zero_supervised_voxels_is_finite_zero():
    logits = torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, N_CLASSES)).astype(np.float32)).requires_grad_()
    labels = torch.full((16,), -1, dtype=torch.int32)
    seg = (torch.zeros(16, dtype=torch.int32),
           torch.tensor([0], dtype=torch.int32),
           torch.tensor([16], dtype=torch.int32), 1)
    for s in (None, seg):
        loss, acc = segmentation_loss(logits, labels, seg=s)
        g, = torch.autograd.grad(loss, logits)
        assert float(loss.detach()) == 0.0 and float(acc) == 0.0
        assert not g.any() and bool(torch.isfinite(g).all())


def test_guarded_step_commits_zero_supervised_batch():
    _, _, tr, st, lab = _setup(batch=2)
    m = tr.step(st, torch.full_like(lab, -1))
    assert m["step_ok"] == 1.0 and m["loss"] == 0.0
    assert tr.last_report.ok


# -- guarded_apply_updates ----------------------------------------------------

def _rand(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 3)).astype(np.float32) * scale,
            "b/w": rng.normal(size=(7,)).astype(np.float32) * scale}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


POISONS = [(float("nan"), "a"), (float("inf"), "b/w"),
           (float("-inf"), "a"), (float("nan"), "loss")]


def _poisoned(poison, where):
    grads = _rand(1, scale=1e-2)
    loss = np.float32(1.5)
    if where == "a":
        grads["a"][2, 1] = poison
    elif where == "b/w":
        grads["b/w"][0] = poison
    else:
        loss = np.float32(poison)
    return grads, loss


@pytest.mark.parametrize("poison,where", POISONS)
def test_guarded_apply_updates_never_writes_nonfinite(poison, where):
    cfg = AdamWConfig(warmup_steps=1, total_steps=10)
    params = _t(_rand(0))
    opt = init_opt_state(params, cfg)
    grads, loss = _poisoned(poison, where)
    p_bytes = [v.numpy().tobytes() for v in params.values()]
    o_bytes = _state_bytes(opt)
    staged, m = guarded_apply_updates(params, _t(grads), opt, cfg,
                                      loss=torch.tensor(loss))
    assert not bool(m["step_ok"])
    # nothing is written until commit, and a refused step never commits
    assert [v.numpy().tobytes() for v in params.values()] == p_bytes
    assert _state_bytes(opt) == o_bytes
    assert all(bool(torch.isfinite(v).all()) for v in params.values())


def test_guarded_apply_updates_finite_path_applies():
    cfg = AdamWConfig(warmup_steps=1, total_steps=10)
    params = _t(_rand(0))
    twin = _t(_rand(0))
    opt = init_opt_state(params, cfg)
    twin_opt = init_opt_state(twin, cfg)
    staged, m = guarded_apply_updates(params, _t(_rand(1, 1e-2)), opt, cfg,
                                      loss=torch.tensor(1.5))
    assert bool(m["step_ok"])
    new = staged.commit()
    assert new.step == 1
    assert not torch.equal(params["a"], _t(_rand(0))["a"])
    # a committed guarded update is bitwise the plain one
    _, plain, _ = apply_updates(twin, _t(_rand(1, 1e-2)), twin_opt, cfg)
    for k in params:
        assert torch.equal(params[k], twin[k])
        assert torch.equal(new.mu[k], plain.mu[k])
        assert torch.equal(new.nu[k], plain.nu[k])


@pytest.mark.parametrize("poison,where", POISONS + [(None, None)])
def test_guarded_apply_updates_flags_match_jax(poison, where):
    """Same parameters, gradients and poison positions in both packages:
    the same ok flag; where ok, the committed update within 1e-6 of
    max|ref| of JAX's (the scalar factors round differently)."""
    cfg = dict(warmup_steps=1, total_steps=10)
    base = _rand(0)
    grads, loss = (_poisoned(poison, where) if poison is not None
                   else (_rand(1, 1e-2), np.float32(1.5)))
    jp = {k: jnp.asarray(v) for k, v in base.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    jcfg = jopt.AdamWConfig(**cfg)
    jnew, jst, jm = jguard.guarded_apply_updates(
        jp, jg, jopt.init_opt_state(jp, jcfg), jcfg, loss=jnp.asarray(loss))
    params = _t(base)
    tcfg = AdamWConfig(**cfg)
    staged, m = guarded_apply_updates(params, _t(grads),
                                      init_opt_state(params, tcfg), tcfg,
                                      loss=torch.tensor(loss))
    assert bool(m["step_ok"]) == bool(jm["step_ok"])
    if bool(m["step_ok"]):
        new = staged.commit()
        assert new.step == int(jst.step) == 1
        for k, v in jnew.items():
            r = np.asarray(v)
            np.testing.assert_allclose(params[k].numpy(), r, rtol=0,
                                       atol=1e-6 * np.abs(r).max())
    else:
        for k in base:
            assert params[k].numpy().tobytes() == base[k].tobytes()
            assert np.asarray(jnew[k]).tobytes() == base[k].tobytes()


# -- the port against the JAX package's guarded trainer -----------------------

def test_guarded_trainer_matches_jax_on_a_poisoned_sequence():
    """Same scenes and weights (``params_from_jax``) through both packages'
    guarded trainers on one sequence: clean, NaN in scene 1, label poison,
    clean, clean. The weights are the JAX plain trainer's after 15 steps
    (as in the reference's spike test: at random init every label costs
    about ln 6, so label poison cannot stand out). Counters and reports
    (action, committed, quarantined) equal exactly. Weights within 1e-4 of
    max|ref| per tensor, the training parity tolerance of
    tests/test_torch_train.py; biases within 1e-3 of it. A bias feeds
    ReLU then per-scene BN, whose mean subtraction cancels its gradient
    on a channel where ReLU passes every row, leaving rounding noise that
    AdamW's per-element normalisation (m̂ / √v̂) turns into a step of the
    same size as a real one (the stem bias differs by 1.4e-4 of max|ref|
    after the five steps, every weight by 4e-6 or less)."""
    g = dict(spike_window=6, spike_factor=1.8, spike_min_history=2)
    opt = dict(lr=2e-2, warmup_steps=2, total_steps=100, weight_decay=0.0)
    sb = jscenes.scene_batch(seed=0, batch=2, kind="indoor", extent=EXTENT,
                             labels=True, n_classes=N_CLASSES)
    jnet = jpc.tiny_segnet(in_channels=4, n_classes=N_CLASSES, width=8,
                           depth=3)
    js = j_compile(jnet, sb[0].layout,
                   params=jpc.init_pointcloud(jax.random.key(0), jnet),
                   batch=2)
    jtcfg = jtr.PointCloudTrainConfig(opt=jopt.AdamWConfig(**opt))
    jst, jlab = jtr.labeled_batch(sb, js.layout)
    warm = js.compile_train(jtcfg)
    for _ in range(15):
        warm.step(jst, jlab)
    jparams = js.params
    jtrainer = js.compile_train(jtcfg, guard=jguard.GuardConfig(**g))

    layout = BitLayout(**dataclasses.asdict(sb[0].layout))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), _net(),
                            device=CPU)
    ts = compile_network(_net(), layout, params=model, batch=2, device=CPU)
    ttrainer = ts.compile_train(
        PointCloudTrainConfig(opt=AdamWConfig(**opt)),
        guard=GuardConfig(**g))
    tst, tlab = labeled_batch(sb, ts.layout, device=CPU)
    np.testing.assert_array_equal(tst.packed.numpy(), np.asarray(jst.packed))

    n = int(tst.count)
    seq = [
        (jst, jlab, tst, tlab),
        (jfaults.poison_scene_nonfinite(jst, 1), jlab,
         tf.poison_scene_nonfinite(tst, 1), tlab),
        (jst, jfaults.poison_labels(jlab, rows=range(n)),
         tst, tf.poison_labels(tlab, rows=range(n))),
        (jst, jlab, tst, tlab),
        (jst, jlab, tst, tlab),
    ]
    reports = []
    for jx, jl, tx, tl in seq:
        jm = jtrainer.step(jx, jl)
        tm = ttrainer.step(tx, tl)
        jr, tr_ = jtrainer.last_report, ttrainer.last_report
        assert (tr_.action, tr_.committed, tr_.quarantined, tr_.nonfinite,
                tr_.spike, tr_.step) == (jr.action, jr.committed,
                                         jr.quarantined, jr.nonfinite,
                                         jr.spike, jr.step)
        assert tm["step_ok"] == float(jm["step_ok"])
        reports.append(tr_)
    assert [r.action for r in reports] == ["ok", "bisected", "bisected",
                                           "ok", "ok"]
    assert reports[1].nonfinite and reports[1].committed == [[0]]
    assert reports[1].quarantined == [1]
    # label poison on both scenes: a spike, and each scene alone too
    assert reports[2].spike and reports[2].quarantined == [0, 1]
    assert ttrainer.counters == jtrainer.counters
    want = dict(params_from_jax(jax.tree.map(np.asarray, js.params), _net(),
                                device=CPU).named_parameters())
    for k, p in ts.params.named_parameters():
        r = want[k].detach().numpy()
        tol = 1e-3 if k.endswith(".bias") else 1e-4
        np.testing.assert_allclose(p.detach().numpy(), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=k)
    assert ttrainer.opt_state.step == int(jtrainer.opt_state.step) == 4
