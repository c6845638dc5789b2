"""The port's fault-injection suite: ``tests/test_faults.py`` mirrored on
``repro_torch.serve`` (the serving stack's degraded-mode contract).

Same scenes, same tiny network, on the CPU (``device="cpu"``); the
engine-parametrised tests run the port's ``zdelta`` search and its
``zdelta_cuda`` engine, whose wrappers take their plain versions on CPU
tensors. The load-bearing assertions, as in the reference:

* poison isolation is bitwise (bisection quarantine; B−1 innocents equal
  to a clean run);
* transient faults are retried with capped backoff, in the serial and the
  pack-ahead loop;
* overflow escalates instead of truncating;
* the bounded queue sheds at submit, expired requests die at drain.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SparseTensor, SpConvSpec
from repro_torch.data import scenes
from repro_torch.models.pointcloud import PointCloudNet
from repro_torch.serve import (FakeClock, FaultySession, HealthReport,
                               PointCloudRequest, PointCloudServeEngine,
                               PoisonError, TransientError, compile_network,
                               feature_poison, poison_coords,
                               poison_features)

torch.set_num_threads(1)

CPU = "cpu"


def _tiny_net(ws_capacity=None):
    # l0 is weight-stationary so the overflow-escalation tests compare a
    # capped session against the lossless (ws_capacity=None) one within a
    # single dataflow; None drops nothing by construction.
    specs = (
        SpConvSpec("l0", 4, 8, K=3, m_in=0, m_out=0, dataflow="ws",
                   ws_capacity=ws_capacity),
        SpConvSpec("l1", 8, 8, K=3, m_in=0, m_out=1),
        SpConvSpec("l2", 8, 8, K=3, m_in=1, m_out=1),
    )
    return PointCloudNet("tiny_faults", specs, in_channels=4, n_classes=5)


@pytest.fixture(scope="module")
def world():
    batch = scenes.scene_batch(seed=7, batch=4, kind="indoor",
                               extent=(28, 24, 16), overlap=0.5)
    rng = np.random.default_rng(7)
    clouds = [(sc.coords,
               rng.normal(size=(len(sc.coords), 4)).astype(np.float32))
              for sc in batch]
    return batch[0].layout, clouds


@pytest.fixture(scope="module")
def session(world):
    layout, _ = world
    return compile_network(_tiny_net(), layout, batch=4, min_bucket=128,
                           device=CPU)


@pytest.fixture(scope="module")
def clean(world, session):
    _, clouds = world
    reqs = [PointCloudRequest(c, f) for c, f in clouds]
    PointCloudServeEngine(session).run(reqs)
    assert all(r.outcome == "ok" for r in reqs)
    return reqs


def _reqs(clouds):
    return [PointCloudRequest(c, f.copy()) for c, f in clouds]


# ---------------------------------------------------------------------------
# poison quarantine by bisection (acceptance: bitwise isolation)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["zdelta", "zdelta_cuda"])
def test_poison_isolated_bitwise(world, engine):
    layout, clouds = world
    sess = compile_network(_tiny_net(), layout, batch=4, engine=engine,
                           min_bucket=128, device=CPU)
    ref = _reqs(clouds)
    PointCloudServeEngine(sess).run(ref)
    assert all(r.outcome == "ok" for r in ref)

    poisoned = [(c, f.copy()) for c, f in clouds]
    poisoned[2] = (poisoned[2][0], poison_features(poisoned[2][1]))
    fs = FaultySession(sess, poison=feature_poison())
    eng = PointCloudServeEngine(fs)
    reqs = _reqs(poisoned)
    eng.run(reqs)        # must not raise

    assert [r.outcome for r in reqs] == ["ok", "ok", "quarantined", "ok"]
    assert "PoisonError" in reqs[2].error and reqs[2].logits is None
    assert eng.quarantined == 1
    for i in (0, 1, 3):   # B-1 innocents: bitwise equal to the clean run
        np.testing.assert_array_equal(reqs[i].logits, ref[i].logits,
                                      err_msg=f"request {i} logits")
        np.testing.assert_array_equal(reqs[i].voxels, ref[i].voxels,
                                      err_msg=f"request {i} voxels")


def test_two_poisoned_requests_both_cornered(world, session, clean):
    _, clouds = world
    poisoned = [(c, f.copy()) for c, f in clouds]
    for i in (0, 3):
        poisoned[i] = (poisoned[i][0], poison_features(poisoned[i][1]))
    eng = PointCloudServeEngine(FaultySession(session,
                                              poison=feature_poison()))
    reqs = _reqs(poisoned)
    eng.run(reqs)
    assert [r.outcome for r in reqs] == ["quarantined", "ok", "ok",
                                         "quarantined"]
    assert eng.quarantined == 2
    for i in (1, 2):
        np.testing.assert_array_equal(reqs[i].logits, clean[i].logits)


def test_validation_isolates_exact_scene(world, session, clean):
    layout, clouds = world
    bad = [(c, f) for c, f in clouds]
    bad[1] = (poison_coords(bad[1][0], layout), bad[1][1])
    eng = PointCloudServeEngine(session)
    reqs = _reqs(bad)
    eng.run(reqs)
    assert [r.outcome for r in reqs] == ["ok", "invalid", "ok", "ok"]
    assert "contract" in reqs[1].error
    assert eng.invalid == 1
    np.testing.assert_array_equal(reqs[0].logits, clean[0].logits)
    np.testing.assert_array_equal(reqs[2].logits, clean[2].logits)


def test_engine_clip_policy_serves_degraded(world, session):
    layout, clouds = world
    bad = [(c, f) for c, f in clouds]
    bad[1] = (poison_coords(bad[1][0], layout), bad[1][1])
    eng = PointCloudServeEngine(session, validate="clip")
    reqs = _reqs(bad)
    eng.run(reqs)
    assert all(r.outcome == "ok" for r in reqs)   # clamped, not rejected
    assert eng.invalid == 0


# ---------------------------------------------------------------------------
# transient faults: retry with capped backoff
# ---------------------------------------------------------------------------

def test_transient_fault_retried_with_capped_backoff(world, session, clean):
    _, clouds = world
    ck = FakeClock()
    fs = FaultySession(session, fail_calls={0, 1, 2})
    eng = PointCloudServeEngine(fs, sleep=ck.sleep, max_retries=3,
                                backoff=0.01, backoff_cap=0.03)
    reqs = _reqs(clouds)
    eng.run(reqs)
    assert all(r.outcome == "ok" for r in reqs)
    assert eng.retries == 3
    assert ck.sleeps == [0.01, 0.02, 0.03]       # exponential, then capped
    np.testing.assert_array_equal(reqs[0].logits, clean[0].logits)


def test_persistent_transient_exhausts_retries_then_bisects(world, session):
    _, clouds = world
    ck = FakeClock()
    # every call fails: retries exhaust, bisection corners every request
    fs = FaultySession(session, fail_calls=range(10 ** 6))
    eng = PointCloudServeEngine(fs, sleep=ck.sleep, max_retries=1)
    reqs = _reqs(clouds)
    eng.run(reqs)        # must not raise
    assert all(r.outcome == "quarantined" for r in reqs)
    assert eng.quarantined == len(reqs)
    assert "TransientError" in reqs[0].error


def test_non_transient_error_not_retried(world, session):
    _, clouds = world
    ck = FakeClock()
    fs = FaultySession(session, fail_calls={0}, exc=ZeroDivisionError)
    eng = PointCloudServeEngine(fs, sleep=ck.sleep)
    reqs = _reqs(clouds[:1])
    eng.run(reqs)
    assert reqs[0].outcome == "quarantined"
    assert ck.sleeps == [] and eng.retries == 0


# ---------------------------------------------------------------------------
# pack-ahead pipelined loop: no batch is ever lost (regression)
# ---------------------------------------------------------------------------

def test_pack_ahead_transient_midstream_no_loss(world, session, clean):
    """A session fault on batch t retries in place and everything is
    served (the reference's regression for a lost batch t)."""
    _, clouds = world
    ck = FakeClock()
    fs = FaultySession(session, fail_calls={1})   # fault on the 2nd call
    eng = PointCloudServeEngine(fs, max_batch=2, pack_ahead=True,
                                sleep=ck.sleep)
    reqs = _reqs(clouds)
    out = eng.run(reqs)       # must not raise
    assert out is not None
    assert all(r.outcome == "ok" for r in reqs)
    assert len(eng.pending) == 0
    assert eng.retries == 1
    for i in range(4):
        np.testing.assert_array_equal(reqs[i].logits, clean[i].logits)


def test_pack_ahead_poison_midstream_isolates_not_raises(world, session,
                                                         clean):
    _, clouds = world
    poisoned = [(c, f.copy()) for c, f in clouds]
    poisoned[2] = (poisoned[2][0], poison_features(poisoned[2][1]))
    eng = PointCloudServeEngine(FaultySession(session,
                                              poison=feature_poison()),
                                max_batch=2, pack_ahead=True)
    reqs = _reqs(poisoned)
    eng.run(reqs)
    assert [r.outcome for r in reqs] == ["ok", "ok", "quarantined", "ok"]
    for i in (0, 1, 3):
        np.testing.assert_array_equal(reqs[i].logits, clean[i].logits)


# ---------------------------------------------------------------------------
# admission control + deadlines
# ---------------------------------------------------------------------------

def test_bounded_queue_sheds_at_submit(world, session):
    _, clouds = world
    ck = FakeClock()
    eng = PointCloudServeEngine(session, clock=ck, max_queue=2)
    reqs = _reqs(clouds)
    admitted = [eng.submit(r) for r in reqs]
    assert admitted == [True, True, False, False]
    assert [r.outcome for r in reqs[2:]] == ["shed", "shed"]
    assert "queue full" in reqs[2].error
    assert eng.shed == 2 and eng.admitted == 2
    while eng.pending:
        eng.step()
    assert [r.outcome for r in reqs[:2]] == ["ok", "ok"]


def test_deadline_expires_at_drain_time(world, session, clean):
    _, clouds = world
    ck = FakeClock()
    eng = PointCloudServeEngine(session, clock=ck)
    reqs = _reqs(clouds)
    reqs[1].deadline = 5.0
    reqs[3].deadline = 100.0
    for r in reqs:
        eng.submit(r)
    ck.advance(10.0)                       # request 1's deadline passes
    served = []
    while eng.pending:
        served += eng.step()
    assert [r.outcome for r in reqs] == ["ok", "deadline_expired", "ok",
                                         "ok"]
    assert eng.deadline_expired == 1
    assert reqs[1] in served               # finalized requests are reported
    np.testing.assert_array_equal(reqs[3].logits, clean[3].logits)


# ---------------------------------------------------------------------------
# overflow escalation (acceptance: replan instead of silent truncation)
# ---------------------------------------------------------------------------

def _max_pairs(session, st, layer="l0"):
    m = session.plan(st).kmaps[layer].m
    return int((m >= 0).sum(dim=0).max())


def test_overflow_escalation_matches_lossless_bitwise(world):
    layout, clouds = world
    lossless = compile_network(_tiny_net(), layout, min_bucket=128,
                               device=CPU)
    st = SparseTensor.from_point_cloud(*clouds[0], lossless.layout,
                                       device=CPU)
    ref, h_ref = lossless.run_with_health(st)
    assert h_ref.ok and h_ref.replans == 0

    # a WS layer tuned to half the scene's real pair demand: level-0 call
    # drops pairs, one escalation (capacity doubled) is lossless again
    p = _max_pairs(lossless, st)
    cap = (p + 1) // 2
    sess = compile_network(_tiny_net(ws_capacity=cap), layout,
                           min_bucket=128, params=lossless.params,
                           device=CPU)
    out, health = sess.run_with_health(st)
    assert isinstance(health, HealthReport)
    assert health.replans == 1 and health.escalation == 1
    assert health.ok and health.total_ws_dropped == 0
    assert sess.last_health is health
    n = int(ref.count)
    assert int(out.count) == n
    np.testing.assert_array_equal(out.features.numpy()[:n],
                                  ref.features.numpy()[:n])


def test_overflow_budget_exhausted_reports_degradation(world):
    layout, clouds = world
    sess = compile_network(_tiny_net(ws_capacity=4), layout, min_bucket=128,
                           max_overflow_replans=0, device=CPU)
    st = SparseTensor.from_point_cloud(*clouds[0], sess.layout, device=CPU)
    out, health = sess.run_with_health(st)
    assert not health.ok and health.replans == 0
    assert health.ws_dropped_pairs["l0"] > 0
    assert "ws_dropped" in health.summary()
    assert int(out.count) > 0          # degraded logits are still served


def test_engine_surfaces_health_and_replan_counter(world):
    layout, clouds = world
    lossless = compile_network(_tiny_net(), layout, min_bucket=128,
                               device=CPU)
    st = SparseTensor.from_point_cloud(*clouds[0], lossless.layout,
                                       device=CPU)
    cap = (_max_pairs(lossless, st) + 1) // 2
    sess = compile_network(_tiny_net(ws_capacity=cap), layout, batch=1,
                           min_bucket=128, params=lossless.params,
                           device=CPU)
    eng = PointCloudServeEngine(sess)
    req = PointCloudRequest(*clouds[0])
    eng.run([req])
    assert req.outcome == "ok"
    assert req.health is not None and req.health.replans >= 1
    assert eng.counters["overflow_replans"] >= 1


# ---------------------------------------------------------------------------
# harness plumbing
# ---------------------------------------------------------------------------

def test_faulty_session_counts_and_proxies(world, session):
    _, clouds = world
    fs = FaultySession(session, fail_calls={0})
    assert fs.layout == session.layout
    assert fs.num_scenes == session.num_scenes
    assert fs.device == session.device
    st = SparseTensor.from_point_clouds(clouds[:2], session.layout,
                                        device=CPU)
    with pytest.raises(TransientError, match="call 0"):
        fs(st)
    out = fs(st)                        # call 1 succeeds
    assert fs.calls == 2 and fs.faults_raised == 1
    assert int(out.count) > 0
    bad = SparseTensor.from_point_clouds(
        [(clouds[0][0], poison_features(clouds[0][1]))], session.layout,
        device=CPU)
    # the predicate reads the packed features as torch tensors
    poisoned = FaultySession(session, poison=feature_poison())
    with pytest.raises(PoisonError, match="call 0"):
        poisoned(bad)
    assert poisoned.faults_raised == 1


def test_engine_rejects_non_session_but_accepts_ducks(world, session):
    with pytest.raises(TypeError, match="SpiraSession"):
        PointCloudServeEngine(object())
    PointCloudServeEngine(FaultySession(session))   # duck-typed: accepted
