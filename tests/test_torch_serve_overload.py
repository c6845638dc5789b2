"""The port's overload-robustness suite: ``tests/test_overload.py``
mirrored on ``repro_torch.serve`` (scheduling, admission, breaker,
ladder, loadgen), plus the reference's hypothesis property
``test_property.py::test_serve_overload_every_request_terminal``.

On the CPU (``device="cpu"``); the engine-parametrised tests run the
port's ``zdelta`` search and its ``zdelta_cuda`` engine (plain versions on
CPU tensors). The watchdog test waits only with bounds and releases the
hung call in a ``finally``, so no test can hang the suite.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import BitLayout, SparseTensor, SpConvSpec
from repro_torch.data import scenes
from repro_torch.models.pointcloud import PointCloudNet
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import (AdmissionConfig, AdmissionController,
                               BreakerConfig, BucketScheduler,
                               DegradationLadder, FakeClock, FaultySession,
                               LadderConfig, PointCloudRequest,
                               PointCloudServeEngine, arrival_times,
                               bucket_capacity, compile_network,
                               feature_poison, make_traffic, run_open_loop)

torch.set_num_threads(1)

CPU = "cpu"


def _tiny_net():
    specs = (
        SpConvSpec("l0", 4, 8, K=3, m_in=0, m_out=0, dataflow="ws"),
        SpConvSpec("l1", 8, 8, K=3, m_in=0, m_out=1),
        SpConvSpec("l2", 8, 8, K=3, m_in=1, m_out=1),
    )
    return PointCloudNet("tiny_overload", specs, in_channels=4, n_classes=5)


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


class _StubSession:
    """Duck-typed identity session: control-flow tests need the engine's
    queue/breaker/ladder machinery, not a compiled network. Returns the
    packed tensor as its own 'logits' (channels == n_classes as far as the
    engine cares), so answers are cheap and deterministic."""

    def __init__(self, layout, num_scenes=4, min_bucket=128):
        self.layout = layout
        self.num_scenes = num_scenes
        self.min_bucket = min_bucket
        self.calls = 0

    def run_with_health(self, st, **kw):
        self.calls += 1
        return st, None

    def __call__(self, st):
        return self.run_with_health(st)[0]


def _req(cloud, deadline=None):
    c, f = cloud
    r = PointCloudRequest(np.array(c, copy=True), np.array(f, copy=True))
    r.deadline = deadline
    return r


# ---------------------------------------------------------------------------
# deadline hygiene (satellite bugfixes)
# ---------------------------------------------------------------------------

def test_dead_on_arrival_expires_at_submit(world):
    layout, clouds = world
    ck = FakeClock(5.0)
    eng = PointCloudServeEngine(_StubSession(layout), clock=ck)
    r = _req(clouds[0], deadline=1.0)          # already past at submit
    assert eng.submit(r) is False
    assert r.outcome == "deadline_expired" and len(eng.pending) == 0
    assert eng.deadline_expired == 1 and eng.admitted == 0


def test_dead_head_does_not_hold_max_wait_timer(world):
    """A request expires while queued at the head; the max_wait hold must
    key off the oldest LIVE request, and the dead one must be excised
    before any device work — in the same step."""
    layout, clouds = world
    ck = FakeClock()
    stub = _StubSession(layout)
    eng = PointCloudServeEngine(stub, clock=ck)
    dead = _req(clouds[0], deadline=1.0)
    eng.submit(dead)
    ck.advance(2.0)                            # dead's deadline passes
    live = _req(clouds[1])
    eng.submit(live)                           # live arrives at t=2
    # the old engine: head of queue arrived at t=0, so 2.0 - 0.0 >= max_wait
    # would dispatch a partial batch immediately WITH the dead head drained.
    out = eng.step(max_wait=10.0)
    assert out == [dead] and dead.outcome == "deadline_expired"
    assert stub.calls == 0                     # no device work for the dead
    assert len(eng.pending) == 1               # live still held (young)
    ck.advance(10.0)                           # live's hold expires
    out = eng.step(max_wait=10.0)
    assert out == [live] and live.outcome == "ok"


def test_expiring_entire_queue_is_safe(world):
    """A whole queue expiring at once: step(max_wait=) must not read an
    arrival time once expiry finalization has emptied the queue."""
    layout, clouds = world
    ck = FakeClock()
    eng = PointCloudServeEngine(_StubSession(layout), clock=ck)
    reqs = [_req(clouds[i % len(clouds)], deadline=1.0) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    ck.advance(5.0)                            # everything expires
    out = eng.step(max_wait=10.0)              # must not raise
    assert sorted(map(id, out)) == sorted(map(id, reqs))
    assert all(r.outcome == "deadline_expired" for r in reqs)
    assert len(eng.pending) == 0 and eng.step(max_wait=10.0) == []


# ---------------------------------------------------------------------------
# bucket scheduler (tentpole: multi-bucket in-flight batching, EDF)
# ---------------------------------------------------------------------------

def test_bucket_scheduler_edf_and_excision(world):
    layout, clouds = world
    sched = BucketScheduler(min_bucket=128)
    small = [(clouds[0][0][:96], clouds[0][1][:96])] * 4
    r_late = _req(small[0], deadline=9.0)
    r_early = _req(small[1], deadline=3.0)
    r_none = _req(small[2])                    # no deadline: ranks last
    r_doom = _req(small[3], deadline=1.0)
    for r in (r_none, r_late, r_doom, r_early):
        sched.push(r, at=0.0)
    assert len(sched) == 4
    dead = sched.expire(2.0)                   # doom's deadline passed
    assert [r for r, _at in dead] == [r_doom]
    batch, _ = sched.drain(2.0, max_batch=4)
    assert batch == [r_early, r_late, r_none]  # EDF, deadline-less last
    assert not sched


def test_bucket_scheduler_prefers_full_bucket(world):
    layout, clouds = world
    sched = BucketScheduler(min_bucket=128)
    small = (clouds[0][0][:96], clouds[0][1][:96])
    big = clouds[1]
    assert len(big[0]) > 128                   # distinct pow2 buckets
    urgent_big = _req(big, deadline=0.5)
    sched.push(urgent_big, at=0.0)
    smalls = [_req(small) for _ in range(4)]
    for r in smalls:
        sched.push(r, at=0.0)
    # the small bucket is full: it dispatches first even though the big
    # bucket holds the most urgent request ...
    batch, _ = sched.drain(0.0, max_batch=4)
    assert batch == smalls
    # ... then urgency picks the big bucket
    batch, _ = sched.drain(0.0, max_batch=4)
    assert batch == [urgent_big]


@pytest.mark.parametrize("engine", ["zdelta", "zdelta_cuda"])
def test_bucket_batches_homogeneous_and_bitwise(world, engine):
    """Mixed-size traffic under scheduler="bucket": every dispatched batch
    is bucket-homogeneous, and every answer is bitwise identical to the
    FIFO engine's on the same requests — on both indexing engines."""
    layout, clouds = world
    sess = compile_network(_tiny_net(), layout, batch=4, engine=engine,
                           min_bucket=128, device=CPU)
    small = [(c[:96], f[:96]) for c, f in clouds[:2]]
    mixed = [clouds[0], small[0], clouds[1], small[1], clouds[2], clouds[3]]

    ref = [_req(cl) for cl in mixed]
    PointCloudServeEngine(sess).run(ref)       # FIFO baseline
    assert all(r.outcome == "ok" for r in ref)

    seen_buckets = []
    base_run = sess.run_with_health

    def spy(st, **kw):
        counts = [int(c) for c in st.scene_segments()[1] if int(c) > 0]
        buckets = {bucket_capacity(c, min_bucket=128) for c in counts}
        assert len(buckets) == 1, f"mixed-bucket batch: {counts}"
        seen_buckets.append(buckets.pop())
        return base_run(st, **kw)

    sess.run_with_health = spy
    try:
        reqs = [_req(cl) for cl in mixed]
        eng = PointCloudServeEngine(sess, scheduler="bucket")
        eng.run(reqs)
    finally:
        del sess.run_with_health               # restore the bound method
    assert all(r.outcome == "ok" for r in reqs)
    # both buckets were dispatched, each in its own homogeneous batch
    scene_buckets = [bucket_capacity(max(len(c), 1), min_bucket=128)
                     for c, _f in mixed]
    assert set(seen_buckets) == set(scene_buckets)
    assert len(set(scene_buckets)) >= 2
    for r, want in zip(reqs, ref):
        np.testing.assert_array_equal(r.logits, want.logits)
        np.testing.assert_array_equal(r.voxels, want.voxels)


# ---------------------------------------------------------------------------
# adaptive admission (CoDel on queue delay)
# ---------------------------------------------------------------------------

def test_admission_controller_law():
    ctl = AdmissionController(AdmissionConfig(target=0.05, interval=1.0))
    # below target: always admit
    ctl.observe(0.01, now=0.0)
    assert ctl.offer(0.0, queue_len=3)
    # above target but not yet for a full interval: admit
    ctl.observe(0.2, now=1.0)
    assert ctl.offer(1.5, queue_len=3)
    # standing above target for >= interval: shed starts
    assert not ctl.offer(2.1, queue_len=3)
    assert ctl.sheds == 1
    # the control law spaces the next shed by interval/sqrt(drops+1)
    assert ctl.offer(2.2, queue_len=3)         # inside the spacing: admit
    assert not ctl.offer(2.1 + 1.0 / np.sqrt(2) + 1e-9, queue_len=3)
    # a below-target sample resets everything
    ctl.observe(0.01, now=4.0)
    assert ctl.offer(4.0, queue_len=3) and ctl.offer(5.0, queue_len=3)
    # an idle queue resets too
    ctl.observe(0.2, now=6.0)
    assert ctl.offer(6.0, queue_len=0)
    assert ctl.offer(7.5, queue_len=1)


def test_engine_admission_sheds_under_standing_delay(world):
    layout, clouds = world
    ck = FakeClock()
    eng = PointCloudServeEngine(
        _StubSession(layout), max_batch=2, clock=ck,
        admission=AdmissionConfig(target=0.05, interval=0.5))
    small = (clouds[0][0][:96], clouds[0][1][:96])
    # build standing delay: queue 4, drain only 2 — waits of 0.2 >> target
    aged = [_req(small) for _ in range(4)]
    for r in aged:
        eng.submit(r)
    ck.advance(0.2)
    eng.step()                                 # samples 0.2: delay starts
    assert aged[0].outcome == aged[1].outcome == "ok"
    ck.advance(0.4)                            # t=0.6: queue still waiting
    later = [_req(small) for _ in range(2)]
    for r in later:                            # queue non-idle: no reset
        assert eng.submit(r) is True           # 0.4 < interval: still admits
    ck.advance(0.1)                            # t=0.7: >= interval above
    victim = _req(small)
    assert eng.submit(victim) is False         # CoDel sheds at submit
    assert victim.outcome == "shed" and eng.admission_shed == 1
    assert eng.shed == 1                       # folds into the shed total
    assert "admission control" in victim.error
    while eng.pending:                         # drain the backlog
        eng.step()
    assert all(r.outcome == "ok" for r in aged + later)
    # pressure cleared (queue idle): admission recovers
    ok = _req(small)
    assert eng.submit(ok) is True
    eng.step()
    assert ok.outcome == "ok"


# ---------------------------------------------------------------------------
# circuit breaker + watchdog
# ---------------------------------------------------------------------------

def test_breaker_trips_fails_fast_and_recovers(world):
    layout, clouds = world
    ck = FakeClock()
    stub = _StubSession(layout)
    fs = FaultySession(stub, fail_calls={0, 1}, exc=RuntimeError)
    eng = PointCloudServeEngine(
        fs, max_batch=1, clock=ck,
        breaker=BreakerConfig(threshold=2, cooldown=1.0))
    small = (clouds[0][0][:96], clouds[0][1][:96])
    r0, r1 = _req(small), _req(small)
    for r in (r0, r1):
        eng.submit(r)
        eng.step()
    # two consecutive non-transient failures: quarantined, breaker trips
    assert r0.outcome == r1.outcome == "quarantined"
    assert eng.breaker_trips == 1 and fs.calls == 2
    # open: requests fail fast with NO session call
    fast = [_req(small) for _ in range(3)]
    for r in fast:
        eng.submit(r)
        eng.step()
    assert all(r.outcome == "rejected_open" for r in fast)
    assert eng.rejected_open == 3 and fs.calls == 2     # frozen while open
    # cooldown -> half-open probe succeeds -> closed
    ck.advance(1.5)
    probe = _req(small)
    eng.submit(probe)
    eng.step()
    assert probe.outcome == "ok" and fs.calls == 3
    after = _req(small)
    eng.submit(after)
    eng.step()
    assert after.outcome == "ok"               # closed again


def test_breaker_half_open_failure_reopens(world):
    layout, clouds = world
    ck = FakeClock()
    fs = FaultySession(_StubSession(layout), fail_calls={0, 1, 2},
                       exc=RuntimeError)
    eng = PointCloudServeEngine(
        fs, max_batch=1, clock=ck,
        breaker=BreakerConfig(threshold=2, cooldown=1.0))
    small = (clouds[0][0][:96], clouds[0][1][:96])
    for _ in range(2):                         # trip it
        eng.submit(_req(small))
        eng.step()
    assert eng.breaker_trips == 1
    ck.advance(1.5)
    probe = _req(small)                        # half-open probe fails
    eng.submit(probe)
    eng.step()
    assert probe.outcome == "quarantined" and eng.breaker_trips == 2
    blocked = _req(small)                      # open again: fail fast
    eng.submit(blocked)
    eng.step()
    assert blocked.outcome == "rejected_open" and fs.calls == 3
    ck.advance(1.5)                            # second probe succeeds
    ok = _req(small)
    eng.submit(ok)
    eng.step()
    assert ok.outcome == "ok"


def test_watchdog_converts_hung_dispatch_to_typed_timeout(world):
    """REAL-time test (threading): a wedged session call must become a
    dispatch_timeout outcome — no retry, no bisection — and feed the
    breaker."""
    layout, clouds = world
    fs = FaultySession(_StubSession(layout), hang_calls={0})
    eng = PointCloudServeEngine(
        fs, max_batch=2, dispatch_timeout=0.2,
        breaker=BreakerConfig(threshold=1, cooldown=9.0))
    small = (clouds[0][0][:96], clouds[0][1][:96])
    reqs = [_req(small), _req(small)]
    try:
        for r in reqs:
            eng.submit(r)
        out = eng.step()
        assert sorted(map(id, out)) == sorted(map(id, reqs))
        # the whole batch is finalized with the typed outcome: the hang
        # attributes to no single request, so there is no bisection
        assert all(r.outcome == "dispatch_timeout" for r in reqs)
        assert eng.dispatch_timeouts == 2
        assert fs.calls == 1                   # and no retry
        assert eng.breaker_trips == 1          # a hang is a breaker failure
        blocked = _req(small)
        eng.submit(blocked)
        eng.step()
        assert blocked.outcome == "rejected_open"
    finally:
        fs.hang_release.set()                  # let the daemon thread die


# ---------------------------------------------------------------------------
# degradation ladder
# ---------------------------------------------------------------------------

def test_ladder_walks_up_and_down_with_hysteresis():
    lad = DegradationLadder(LadderConfig(target=0.05, escalate_after=1.0,
                                         deescalate_after=2.0))
    assert lad.rung == 0 and lad.label == "healthy"
    lad.observe(0.2, now=0.0)                  # above: timer starts
    assert lad.observe(0.2, now=0.5) == 0      # not sustained yet
    assert lad.observe(0.2, now=1.0) == 1      # 1s above: rung up
    assert lad.label == "tight_max_wait"
    assert lad.observe(0.2, now=1.5) == 1      # per-rung timer restarted
    assert lad.observe(0.2, now=2.0) == 2      # another 1s: rung up
    assert lad.observe(0.2, now=3.0) == 3
    assert lad.observe(0.2, now=9.0) == 3      # capped at max_rung
    assert lad.escalations == 3
    lad.observe(0.01, now=10.0)                # below: de-escalation timer
    assert lad.observe(0.01, now=11.0) == 3    # hysteresis: 2s required
    assert lad.observe(0.01, now=12.0) == 2
    assert lad.observe(0.2, now=12.5) == 2     # pressure back: timer resets
    lad.observe(0.01, now=13.0)
    assert lad.observe(0.01, now=15.0) == 1
    assert lad.observe(0.01, now=17.0) == 0
    assert lad.observe(0.01, now=30.0) == 0    # floor


def test_rung1_tightens_max_wait(world):
    layout, clouds = world
    ck = FakeClock()
    eng = PointCloudServeEngine(
        _StubSession(layout), clock=ck,
        ladder=LadderConfig(max_wait_factor=0.25))
    eng._ladder.rung = 1
    small = (clouds[0][0][:96], clouds[0][1][:96])
    r = _req(small)
    eng.submit(r)
    ck.advance(3.0)                            # 3s < 10s but >= 10*0.25
    out = eng.step(max_wait=10.0)              # healthy engine would hold
    assert out == [r] and r.outcome == "ok"
    assert r.degradation == 1                  # rung recorded on the ticket


def test_rung2_disables_replan_escalation(world):
    layout, clouds = world
    ck = FakeClock()
    fs = FaultySession(_StubSession(layout))
    eng = PointCloudServeEngine(fs, clock=ck, ladder=LadderConfig())
    small = (clouds[0][0][:96], clouds[0][1][:96])
    r = _req(small)
    eng.submit(r)
    eng.step()
    assert fs.last_call_kwargs == {}           # healthy: no override
    eng._ladder.rung = 2
    r2 = _req(small)
    eng.submit(r2)
    eng.step()
    assert r2.outcome == "ok" and r2.degradation == 2
    assert fs.last_call_kwargs == {"max_replans": 0}


def test_rung2_max_replans_respected_by_real_session(world, session):
    """The session-side hook: max_replans=0 serves at the base plan with
    drops flagged instead of replanning (the escalation opt-out)."""
    layout, clouds = world
    st = SparseTensor.from_point_cloud(*clouds[0], session.layout,
                                       device=CPU)
    out_ref, h_ref = session.run_with_health(st)
    assert h_ref.replans == 0
    m = session.plan(st).kmaps["l0"].m
    demand = int((m >= 0).sum(dim=0).max())
    capped = compile_network(
        PointCloudNet("tiny_capped", (
            SpConvSpec("l0", 4, 8, K=3, m_in=0, m_out=0, dataflow="ws",
                       ws_capacity=(demand + 1) // 2),
            SpConvSpec("l1", 8, 8, K=3, m_in=0, m_out=1),
            SpConvSpec("l2", 8, 8, K=3, m_in=1, m_out=1),
        ), in_channels=4, n_classes=5),
        layout, batch=4, min_bucket=128, params=session.params,
        device=CPU)
    _out, esc = capped.run_with_health(st)
    assert esc.replans == 1 and esc.ok         # escalation cures the drops
    _out, flat = capped.run_with_health(st, max_replans=0)
    assert flat.replans == 0 and not flat.ok   # served degraded, flagged
    assert flat.total_ws_dropped > 0


def test_rung3_downsamples_oversized_scene(world):
    layout, clouds = world
    ck = FakeClock()
    eng = PointCloudServeEngine(
        _StubSession(layout), clock=ck,
        ladder=LadderConfig(voxel_budget=128))
    eng._ladder.rung = 3
    big = clouds[0]
    assert len(big[0]) > 128
    r = _req(big)
    n_before = len(r.coords)
    eng.submit(r)
    eng.step()
    assert r.outcome == "ok" and r.downsampled and r.degradation == 3
    assert len(r.coords) == 128 < n_before     # decimated to the budget
    assert eng.downsampled == 1
    small = _req((big[0][:96], big[1][:96]))   # under budget: untouched
    eng.submit(small)
    eng.step()
    assert small.outcome == "ok" and not small.downsampled
    assert eng.downsampled == 1


# ---------------------------------------------------------------------------
# the acceptance scenario: deterministic 2x overload, both engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["zdelta", "zdelta_cuda"])
def test_two_x_overload_bounded_and_bitwise(world, engine):
    """FakeClock loadgen at 2x capacity: bounded queue delay, nonzero
    goodput, every request terminal, the ladder engages — and every served
    request (none downsampled here) stays BITWISE identical to an unloaded
    run."""
    layout, clouds = world
    ck = FakeClock()
    reg = MetricsRegistry(clock=ck)
    sess = compile_network(_tiny_net(), layout, batch=4, engine=engine,
                           min_bucket=128, metrics=reg, device=CPU)

    # unloaded reference: every distinct cloud served on a quiet engine
    ref = [_req(cl) for cl in clouds]
    PointCloudServeEngine(sess).run(ref)
    assert all(r.outcome == "ok" for r in ref)

    # service time 0.1s per dispatch -> capacity = 4 scenes / 0.1s = 40/s;
    # offer 2x that (80/s) for 40 requests
    fs = FaultySession(sess, delay=0.1, sleep=ck.sleep)
    eng = PointCloudServeEngine(
        fs, clock=ck, max_queue=8,
        admission=AdmissionConfig(target=0.05, interval=0.2),
        ladder=LadderConfig(target=0.05, escalate_after=0.2,
                            deescalate_after=0.5,
                            voxel_budget=1 << 20))   # never downsample here
    reqs = make_traffic(clouds, 40)
    rep = run_open_loop(eng, list(zip(arrival_times(40, rate=80.0), reqs)),
                        ck, idle_tick=0.01)

    # every request reached exactly one terminal outcome
    assert sum(rep.outcomes.values()) == 40
    assert set(rep.outcomes) <= {"ok", "shed"}
    assert rep.outcomes["ok"] > 0 and rep.goodput > 0
    assert rep.outcomes.get("shed", 0) > 0     # overload was real
    assert eng.admission_shed > 0              # CoDel did the shedding...
    assert rep.max_queue_depth <= 8            # ...inside the backstop
    # bounded queue delay: admission keeps waits near target, far below
    # the unbounded-queue figure (40 reqs / 40 per s would stack ~0.5s+)
    assert rep.p99_queue_wait <= 0.5
    assert rep.max_rung >= 1                   # the ladder engaged
    assert eng.degradations >= 1
    # the innocents invariant, extended to degraded mode: every served
    # answer is bitwise identical to the unloaded run of the same cloud
    assert not any(r.downsampled for r in reqs)
    for i, r in enumerate(reqs):
        if r.outcome == "ok":
            want = ref[i % len(clouds)]
            np.testing.assert_array_equal(r.logits, want.logits)
            np.testing.assert_array_equal(r.voxels, want.voxels)


def test_loadgen_scenario_is_deterministic(world):
    """Same schedule + same FakeClock => identical outcome sequence and
    report, run to run (the replayability contract)."""
    layout, clouds = world
    small = [(c[:96], f[:96]) for c, f in clouds]

    def one_run():
        ck = FakeClock()
        stub = _StubSession(layout)
        fs = FaultySession(stub, delay=0.05, sleep=ck.sleep,
                           poison=feature_poison())
        eng = PointCloudServeEngine(
            fs, clock=ck, max_queue=6,
            admission=AdmissionConfig(target=0.05, interval=0.2),
            ladder=LadderConfig(target=0.05, escalate_after=0.2,
                                deescalate_after=0.5))
        reqs = make_traffic(small, 24, poison=(5,),
                            deadlines={11: 0.12})
        rep = run_open_loop(
            eng, list(zip(arrival_times(24, rate=60.0), reqs)), ck)
        return [r.outcome for r in reqs], rep

    out1, rep1 = one_run()
    out2, rep2 = one_run()
    assert out1 == out2
    assert rep1 == rep2
    assert sum(rep1.outcomes.values()) == 24
    assert rep1.outcomes.get("quarantined", 0) == 1    # the poisoned one
    assert rep1.outcomes.get("deadline_expired", 0) >= 1


# ---------------------------------------------------------------------------
# terminal-outcome invariant (deterministic mirror of the hypothesis
# property in test_property.py)
# ---------------------------------------------------------------------------

TERMINAL = {"ok", "invalid", "quarantined", "shed", "deadline_expired",
            "rejected_open", "dispatch_timeout"}


def check_terminal_invariant(eng, reqs):
    """Every submitted request: exactly one terminal outcome, none lost or
    double-finalized (each finalization records exactly one latency sample,
    so the per-outcome histogram counts must sum to len(reqs)), and the
    counters sum back to submissions."""
    n = len(reqs)
    assert all(r.outcome in TERMINAL for r in reqs)
    recorded = sum(
        eng.metrics.histogram(f"serve_latency_{o}").count for o in TERMINAL)
    assert recorded == n, (recorded, n)
    c = eng.counters
    mix = {o: sum(r.outcome == o for r in reqs) for o in TERMINAL}
    assert c["shed"] == mix["shed"]
    assert c["invalid"] == mix["invalid"]
    assert c["quarantined"] == mix["quarantined"]
    assert c["deadline_expired"] == mix["deadline_expired"]
    assert c["rejected_open"] == mix["rejected_open"]
    assert c["dispatch_timeouts"] == mix["dispatch_timeout"]
    assert c["scenes_served"] == mix["ok"]
    # admitted + refused-at-submit == submissions
    refused = mix["shed"] + sum(
        r.outcome == "deadline_expired" and r.submitted_at is not None
        and r.deadline is not None and r.submitted_at > r.deadline
        for r in reqs)
    assert c["admitted"] + refused == n


def test_terminal_outcome_invariant_mixed_faults(world):
    layout, clouds = world
    small = [(c[:96], f[:96]) for c, f in clouds]
    big = [clouds[0], clouds[1]]
    ck = FakeClock()
    reg = MetricsRegistry(clock=ck)
    fs = FaultySession(_StubSession(layout), delay=0.04, sleep=ck.sleep,
                       poison=feature_poison(), fail_calls={3, 9, 10, 11, 12},
                       exc=RuntimeError)
    eng = PointCloudServeEngine(
        fs, clock=ck, max_queue=5, metrics=reg, scheduler="bucket",
        admission=AdmissionConfig(target=0.04, interval=0.15),
        breaker=BreakerConfig(threshold=3, cooldown=0.5),
        ladder=LadderConfig(target=0.04, escalate_after=0.2,
                            deescalate_after=0.4, voxel_budget=128))
    reqs = make_traffic(small + big, 30, poison=(4, 17),
                        deadlines={2: 0.01, 20: -1.0, 25: 0.3})
    run_open_loop(eng, list(zip(arrival_times(30, rate=50.0), reqs)), ck)
    check_terminal_invariant(eng, reqs)
    assert {r.outcome for r in reqs} >= {"ok", "quarantined",
                                         "deadline_expired"}


# ---------------------------------------------------------------------------
# the hypothesis property (mirror of test_property.py's
# test_serve_overload_every_request_terminal, same strategy and settings)
# ---------------------------------------------------------------------------

_serve_req_strategy = st.lists(
    st.tuples(
        st.integers(2, 180),                  # scene size (rows drawn below)
        st.floats(0.0, 0.2),                  # inter-arrival gap (s)
        st.one_of(st.none(), st.floats(-0.5, 2.0)),   # absolute deadline
        st.booleans(),                        # poisoned?
    ),
    min_size=1, max_size=14)


@settings(max_examples=25, deadline=None)
@given(_serve_req_strategy,
       st.sets(st.integers(0, 20), max_size=4),       # failing call indices
       st.integers(0, 2 ** 31 - 1))
def test_serve_overload_every_request_terminal(spec, fail_calls, seed):
    """Under arbitrary arrival schedules, deadlines, scene sizes (mixed
    pow2 buckets) and injected fault mixes, every submitted request
    reaches exactly ONE terminal outcome, and the engine's counters sum
    back to the submissions (``check_terminal_invariant``)."""
    layout = BitLayout.for_extent(220, 170, 100, guard=16)
    rng = np.random.default_rng(seed)
    base = np.array(sorted(set(
        map(tuple, rng.integers((16, 16, 16), (200, 150, 80),
                                size=(200, 3))))), np.int32)
    clouds, arrivals, deadlines, poison = [], [], {}, []
    t = 0.0
    for i, (size, gap, deadline, poisoned) in enumerate(spec):
        size = min(size, len(base))
        clouds.append((base[:size], np.ones((size, 4), np.float32)))
        t += gap
        arrivals.append(t)
        if deadline is not None:
            deadlines[i] = deadline
        if poisoned:
            poison.append(i)

    ck = FakeClock()
    reg = MetricsRegistry(clock=ck)
    fs = FaultySession(_StubSession(layout), delay=0.03, sleep=ck.sleep,
                       poison=feature_poison(), fail_calls=fail_calls,
                       exc=RuntimeError)
    eng = PointCloudServeEngine(
        fs, clock=ck, max_queue=5, metrics=reg, scheduler="bucket",
        admission=AdmissionConfig(target=0.04, interval=0.15),
        breaker=BreakerConfig(threshold=2, cooldown=0.3),
        ladder=LadderConfig(target=0.04, escalate_after=0.2,
                            deescalate_after=0.4, voxel_budget=128))
    reqs = make_traffic(clouds, len(clouds), poison=poison,
                        deadlines=deadlines)
    run_open_loop(eng, list(zip(arrivals, reqs)), ck)
    check_terminal_invariant(eng, reqs)
