"""The port's point-cloud serving engine: the engine tests of
``test_session.py``, ``test_obs.py`` and ``test_train_pointcloud.py``
mirrored on ``repro_torch.serve``, the port's own contracts (CUDA's
out-of-memory error is transient, other errors are not; answers split on
the host equal ``unbatch()`` + ``coords()`` bitwise; the watchdog's span
names), one FakeClock scenario run through the JAX engine and the port's
with the same weights, and the three serving examples on the CPU.
"""
import dataclasses
import json
import runpy
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import SpConvSpec as JSpec
from repro.data import scenes as jscenes
from repro.models.pointcloud import PointCloudNet as JNet
from repro.models.pointcloud import init_pointcloud as j_init
from repro import obs as jobs
from repro import serve as jserve

from repro_torch import serve as tserve
from repro_torch.convert import params_from_jax
from repro_torch.core import BitLayout, SparseTensor, SpConvSpec
from repro_torch.core.zdelta import reset_search_calls, search_call_count
from repro_torch.data import scenes
from repro_torch.models import pointcloud as pc
from repro_torch.models.pointcloud import PointCloudNet
from repro_torch.obs import MetricsRegistry, parse_prometheus_text
from repro_torch.serve import (BreakerConfig, FakeClock, FaultySession,
                               PointCloudRequest, PointCloudServeEngine,
                               compile_network)
from repro_torch.serve.engine import _default_transient, host_answers

torch.set_num_threads(1)

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
EDGE0 = 2.0 ** -20          # first default histogram edge


def _tiny_net(K: int = 3, ws: bool = False, name: str = "tiny"):
    specs = (
        SpConvSpec("l0", 4, 8, K=K, m_in=0, m_out=0,
                   dataflow="ws" if ws else "os"),
        SpConvSpec("l1", 8, 8, K=3, m_in=0, m_out=1),
        SpConvSpec("l2", 8, 8, K=K, m_in=1, m_out=1),
    )
    return PointCloudNet(name, specs, in_channels=4, n_classes=5)


def _clouds(B, seed=7, extent=(28, 24, 16), overlap=0.5):
    batch = scenes.scene_batch(seed=seed, batch=B, kind="indoor",
                               extent=extent, overlap=overlap)
    rng = np.random.default_rng(seed)
    return batch[0].layout, [
        (sc.coords, rng.normal(size=(len(sc.coords), 4)).astype(np.float32))
        for sc in batch]


@pytest.fixture(scope="module")
def world():
    return _clouds(4)


# ---------------------------------------------------------------------------
# the serving loop (test_session.py's engine tests)
# ---------------------------------------------------------------------------

def test_serve_engine_matches_direct_session():
    layout, clouds = _clouds(4)
    sess = compile_network(_tiny_net(), layout, batch=2, min_bucket=128,
                           device=CPU)
    reqs = [PointCloudRequest(coords=c, features=f) for c, f in clouds]
    eng = PointCloudServeEngine(sess)
    eng.run(reqs)
    assert eng.batches_run == 2 and eng.scenes_served == 4
    for (c, f), r in zip(clouds, reqs):
        assert r.done
        direct = sess(SparseTensor.from_point_clouds(
            [(c, f)], sess.layout, device=CPU)).unbatch()[0]
        n = int(direct.count)
        assert r.logits.shape == (n, 5)
        np.testing.assert_array_equal(r.logits, direct.features.numpy()[:n])
        np.testing.assert_array_equal(r.voxels, direct.coords()[0])


def test_serve_engine_pack_ahead_matches_serial():
    """The pipelined serving loop (pack batch t+1 on the worker thread
    while batch t executes) answers every request identically to the
    serial loop and overlaps each pack after the first: the session is
    given a 0.25 s floor per call, so the worker's host pack of 2 small
    scenes always finishes inside it. Every batch reaches the session
    packed on the host."""
    layout, clouds = _clouds(6)
    sess = compile_network(_tiny_net(), layout, batch=2, min_bucket=128,
                           device=CPU)
    reqs_serial = [PointCloudRequest(coords=c, features=f)
                   for c, f in clouds]
    reqs_piped = [PointCloudRequest(coords=c, features=f)
                  for c, f in clouds]
    PointCloudServeEngine(sess).run(reqs_serial)
    slow = FaultySession(sess, delay=0.25)
    devices = []
    base = slow.run_with_health

    def spy(st, **kw):
        devices.append(st.device.type)
        return base(st, **kw)

    slow.run_with_health = spy
    eng = PointCloudServeEngine(slow, pack_ahead=True)
    eng.run(reqs_piped)
    assert eng.batches_run == 3 and eng.scenes_served == 6
    # batches 2 and 3 were packed ahead, each fully hidden by the delay
    assert eng.packs_overlapped == 2
    assert devices == ["cpu"] * 3
    for i, (a, b) in enumerate(zip(reqs_serial, reqs_piped)):
        assert b.done and b.outcome == "ok"
        np.testing.assert_array_equal(a.logits, b.logits,
                                      err_msg=f"request {i} logits")
        np.testing.assert_array_equal(a.voxels, b.voxels,
                                      err_msg=f"request {i} voxels")


def test_pack_ahead_batch_t_survives_transient_failure():
    """A transient session fault on batch t retries in place: every
    request is served, nothing raises, nothing is lost."""
    layout, clouds = _clouds(2)
    sess = compile_network(_tiny_net(), layout, batch=1, min_bucket=128,
                           device=CPU)
    ck = FakeClock()
    flaky = FaultySession(sess, fail_calls={0})   # batch 0's first attempt
    reqs = [PointCloudRequest(coords=c, features=f) for c, f in clouds]
    eng = PointCloudServeEngine(flaky, pack_ahead=True, sleep=ck.sleep)
    eng.run(reqs)                   # must not raise
    assert [r.outcome for r in reqs] == ["ok", "ok"]
    assert all(r.done and r.logits is not None for r in reqs)
    assert len(eng.pending) == 0
    assert eng.retries == 1 and ck.sleeps == [0.01]


# ---------------------------------------------------------------------------
# the instrumented pipeline (test_obs.py's engine tests)
# ---------------------------------------------------------------------------

def test_fake_clock_serve_snapshot_is_exactly_pinned(world):
    """A FakeClock-driven serve run yields exact metrics: every count,
    bucket occupancy and percentile below is arithmetic, not timing."""
    layout, clouds = world
    ck = FakeClock()
    reg = MetricsRegistry(clock=ck)
    session = compile_network(_tiny_net(ws=True), layout, batch=4,
                              min_bucket=128, metrics=reg, device=CPU)
    # each session call burns exactly 1s of fake time inside dispatch
    fs = FaultySession(session, delay=1.0, sleep=ck.sleep)
    eng = PointCloudServeEngine(fs, max_batch=2, clock=ck)
    assert eng.metrics is reg
    reqs = [PointCloudRequest(c, f) for c, f in clouds]
    eng.run(reqs)
    assert all(r.outcome == "ok" for r in reqs)

    snap = reg.snapshot()
    for key, want in [("serve_admitted", 4), ("serve_batches_run", 2),
                      ("serve_scenes_served", 4), ("serve_shed", 0),
                      ("serve_retries", 0), ("session_runs", 2)]:
        assert snap["counters"][key] == want, key
    # queue wait: batch 1 drains at t=0 (0s x2), batch 2 at t=1 (1s x2)
    qw = snap["histograms"]["serve_queue_wait"]
    assert qw["count"] == 4 and qw["sum"] == 2.0
    assert qw["buckets"] == {repr(EDGE0): 2, "1.0": 2}
    assert qw["p50"] == EDGE0 and qw["p90"] == 1.0 and qw["p99"] == 1.0
    # latency: batch 1 served at t=1 (1s x2), batch 2 at t=2 (2s x2)
    lat = snap["histograms"]["serve_latency_ok"]
    assert lat["count"] == 4 and lat["sum"] == 6.0
    assert lat["buckets"] == {"1.0": 2, "2.0": 2}
    assert lat["p50"] == 1.0 and lat["p90"] == 2.0 and lat["p99"] == 2.0
    # dispatch span: the injected 1s delay, twice; pack burns no fake time
    disp = snap["histograms"]["serve/dispatch"]
    assert disp["count"] == 2 and disp["sum"] == 2.0
    assert snap["histograms"]["serve/pack"]["sum"] == 0.0
    # the session call nests under the engine dispatch span on this thread
    assert snap["histograms"]["serve/dispatch/session/call"]["count"] == 2
    # rolling QPS: 4 scenes inside the 60s window
    assert snap["rates"]["serve_qps"] == 4 / 60.0
    assert json.loads(json.dumps(snap)) == snap


def test_zero_overhead_invariant(world):
    """Instrumentation is observational only: results bitwise identical,
    compile keys and kernel-map search counts unchanged between a direct
    session call and the fully instrumented engine path."""
    layout, clouds = world
    s1 = compile_network(_tiny_net(ws=True), layout, batch=4,
                         min_bucket=128, device=CPU)
    s2 = compile_network(_tiny_net(ws=True), layout, batch=4,
                         min_bucket=128, params=s1.params, device=CPU)

    reset_search_calls()
    stb = SparseTensor.from_point_clouds(clouds, s1.layout, device=CPU)
    direct = s1(stb).unbatch()
    direct_logits = [sc.features.numpy()[: int(sc.count)] for sc in direct]
    searches_direct = search_call_count()
    assert searches_direct > 0

    reset_search_calls()
    eng = PointCloudServeEngine(s2)
    reqs = [PointCloudRequest(c, f) for c, f in clouds]
    eng.run(reqs)
    assert search_call_count() == searches_direct
    assert s2.compile_count == s1.compile_count
    for req, want in zip(reqs, direct_logits):
        np.testing.assert_array_equal(req.logits, want)


def test_engine_counters_dict_api_compatible(world):
    """The plain-int counter attributes and the counters dict keep their
    surface while sourcing from the shared registry."""
    layout, clouds = world
    session = compile_network(_tiny_net(ws=True), layout, batch=4,
                              min_bucket=128, device=CPU)
    eng = PointCloudServeEngine(session)
    assert eng.metrics is session.metrics
    assert eng.admitted == 0 and isinstance(eng.admitted, int)
    eng.retries += 1
    assert eng.retries == 1
    assert session.metrics.counter("serve_retries").value == 1
    eng.retries = 0
    reqs = [PointCloudRequest(c, f) for c, f in clouds]
    eng.run(reqs)
    assert eng.counters == {
        "admitted": 4, "shed": 0, "invalid": 0, "quarantined": 0,
        "deadline_expired": 0, "retries": 0, "overflow_replans": 0,
        "batches_run": 1, "scenes_served": 4, "packs_overlapped": 0,
        "rejected_open": 0, "dispatch_timeouts": 0, "admission_shed": 0,
        "breaker_trips": 0, "downsampled": 0, "degradations": 0}
    snap = session.metrics.snapshot()
    assert all(snap["counters"][f"serve_{k}"] == v
               for k, v in eng.counters.items())


def test_breaker_gauge_and_outcome_counters_exported(world):
    """The breaker-state gauge walks closed(0) -> open(2) -> half_open(1)
    -> closed(0), and the outcome counters appear as spira_serve_* series
    in the Prometheus export."""
    layout, clouds = world
    ck = FakeClock()
    reg = MetricsRegistry(clock=ck)
    session = compile_network(_tiny_net(ws=True), layout, batch=4,
                              min_bucket=128, metrics=reg, device=CPU)
    fs = FaultySession(session, fail_calls=range(0, 2), exc=RuntimeError)
    eng = PointCloudServeEngine(fs, max_batch=1, clock=ck,
                                breaker=BreakerConfig(threshold=2,
                                                      cooldown=1.0))
    gauge = reg.gauge("serve_breaker_state")
    assert gauge.value == 0                       # closed at construction
    reqs = [PointCloudRequest(c, f) for c, f in clouds]
    for r in reqs[:2]:                            # two failures: trip
        eng.submit(r)
        eng.step()
    assert gauge.value == 2 and eng.breaker_trips == 1
    eng.submit(reqs[2])                           # open: rejected fast
    eng.step()
    assert reqs[2].outcome == "rejected_open" and eng.rejected_open == 1
    ck.advance(1.5)                               # cooldown -> half-open
    eng.submit(reqs[3])                           # probe succeeds -> closed
    eng.step()
    assert reqs[3].outcome == "ok" and gauge.value == 0

    samples = parse_prometheus_text(reg.to_prometheus_text())
    assert samples["spira_serve_breaker_state"] == [("", 0.0)]
    assert samples["spira_serve_rejected_open"] == [("", 1.0)]
    assert samples["spira_serve_breaker_trips"] == [("", 1.0)]
    assert samples["spira_serve_dispatch_timeouts"] == [("", 0.0)]
    assert "spira_serve_latency_rejected_open_bucket" in samples
    snap = reg.snapshot()
    assert snap["counters"]["serve_quarantined"] == 2  # the trip's failures


def test_watchdog_runs_the_session_on_its_own_thread(world):
    """Under the watchdog the session call runs on a daemon thread with
    its own span stack: the session's span records as ``session/call``,
    not ``serve/dispatch/session/call``, and the answers are the serial
    engine's bits. The engine's wait is bounded by the timeout."""
    layout, clouds = world
    session = compile_network(_tiny_net(ws=True), layout, batch=4,
                              min_bucket=128, device=CPU)
    ref = [PointCloudRequest(c, f) for c, f in clouds]
    PointCloudServeEngine(session).run(ref)
    reg = MetricsRegistry()
    watched = compile_network(_tiny_net(ws=True), layout, batch=4,
                              min_bucket=128, params=session.params,
                              metrics=reg, device=CPU)
    eng = PointCloudServeEngine(watched, dispatch_timeout=60.0)
    reqs = [PointCloudRequest(c, f) for c, f in clouds]
    eng.run(reqs)
    assert all(r.outcome == "ok" for r in reqs)
    hists = reg.snapshot()["histograms"]
    assert hists["session/call"]["count"] == 1
    assert "serve/dispatch/session/call" not in hists
    assert hists["serve/dispatch"]["count"] == 1
    for r, want in zip(reqs, ref):
        np.testing.assert_array_equal(r.logits, want.logits)
        np.testing.assert_array_equal(r.voxels, want.voxels)


# ---------------------------------------------------------------------------
# serving bail-out (test_train_pointcloud.py's engine tests)
# ---------------------------------------------------------------------------

EXTENT = (32, 28, 16)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_engine_max_wait_dispatches_partial_batch():
    """A lone request is answered once it has waited max_wait, even
    though the batch never fills — and not before that."""
    sb = scenes.scene_batch(seed=1, batch=4, kind="indoor", extent=EXTENT)
    net = pc.tiny_segnet(in_channels=4, n_classes=4, width=8, depth=2)
    session = compile_network(net, sb[0].layout, batch=4, device=CPU)
    clock = _FakeClock()
    eng = PointCloudServeEngine(session, clock=clock)

    rng = np.random.default_rng(0)
    req = PointCloudRequest(
        coords=sb[0].coords,
        features=rng.normal(size=(len(sb[0].coords), 4)).astype(np.float32))
    eng.submit(req)
    assert eng.step(max_wait=0.5) == []        # young request: hold
    assert not req.done
    clock.t = 0.49
    assert eng.step(max_wait=0.5) == []        # still inside the bound
    clock.t = 0.51
    served = eng.step(max_wait=0.5)            # bound exceeded: bail out
    assert [req] == served and req.done
    assert req.logits is not None and len(req.logits) == int(
        np.unique(req.coords, axis=0).shape[0])

    # wall-clock sanity: with a real clock a lone request is answered
    # within (roughly) the bound, not blocked on batch fill
    eng2 = PointCloudServeEngine(session)
    req2 = PointCloudRequest(coords=req.coords, features=req.features)
    eng2.submit(req2)
    t0 = time.monotonic()
    while not req2.done:
        eng2.step(max_wait=0.05)
        assert time.monotonic() - t0 < 30     # headroom, not policy
    assert req2.done


def test_engine_full_batch_dispatches_immediately():
    sb = scenes.scene_batch(seed=2, batch=2, kind="indoor", extent=EXTENT)
    net = pc.tiny_segnet(in_channels=4, n_classes=4, width=8, depth=2)
    session = compile_network(net, sb[0].layout, batch=2, device=CPU)
    clock = _FakeClock()
    eng = PointCloudServeEngine(session, clock=clock)
    rng = np.random.default_rng(1)
    for sc in sb:
        eng.submit(PointCloudRequest(
            coords=sc.coords,
            features=rng.normal(size=(len(sc.coords), 4)).astype(np.float32)))
    served = eng.step(max_wait=10.0)           # full batch: no hold at t=0
    assert len(served) == 2 and all(r.done for r in served)


# ---------------------------------------------------------------------------
# which faults are transient on the card
# ---------------------------------------------------------------------------

def test_cuda_out_of_memory_retried_as_transient(world):
    """``torch.OutOfMemoryError`` is CUDA's counterpart of XLA's
    RESOURCE_EXHAUSTED: retried with backoff, then served bitwise."""
    layout, clouds = world
    session = compile_network(_tiny_net(ws=True), layout, batch=4,
                              min_bucket=128, device=CPU)
    ref = [PointCloudRequest(c, f) for c, f in clouds]
    PointCloudServeEngine(session).run(ref)
    ck = FakeClock()
    fs = FaultySession(session, fail_calls={0, 1},
                       exc=torch.OutOfMemoryError)
    eng = PointCloudServeEngine(fs, sleep=ck.sleep)
    reqs = [PointCloudRequest(c, f) for c, f in clouds]
    eng.run(reqs)
    assert all(r.outcome == "ok" for r in reqs)
    assert eng.retries == 2 and ck.sleeps == [0.01, 0.02]
    assert eng.quarantined == 0 and fs.faults_raised == 2
    for r, want in zip(reqs, ref):
        np.testing.assert_array_equal(r.logits, want.logits)


def test_other_cuda_errors_not_retried(world):
    """Any other CUDA error (an illegal address poisons the context) is
    non-transient: no retry, straight to bisection and the breaker."""
    layout, clouds = world
    session = compile_network(_tiny_net(ws=True), layout, batch=4,
                              min_bucket=128, device=CPU)
    ck = FakeClock()

    def illegal(msg):
        return RuntimeError("CUDA error: an illegal memory access was "
                            f"encountered ({msg})")

    fs = FaultySession(session, fail_calls=range(10 ** 6), exc=illegal)
    eng = PointCloudServeEngine(fs, sleep=ck.sleep, clock=ck,
                                breaker=BreakerConfig(threshold=2,
                                                      cooldown=9.0))
    reqs = [PointCloudRequest(c, f) for c, f in clouds[:2]]
    eng.run(reqs)
    # the batch fails (breaker failure 1), its first half alone fails
    # (failure 2: the breaker opens), the second half is failed fast
    assert [r.outcome for r in reqs] == ["quarantined", "rejected_open"]
    assert "illegal memory access" in reqs[0].error
    assert eng.retries == 0 and ck.sleeps == []
    assert eng.breaker_trips == 1 and fs.calls == 2
    assert _default_transient(torch.OutOfMemoryError("CUDA out of memory"))
    assert _default_transient(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
    assert not _default_transient(RuntimeError("CUDA error: misaligned"))


# ---------------------------------------------------------------------------
# the host answer split
# ---------------------------------------------------------------------------

def _int64_clouds(B):
    layout = BitLayout.for_extent(4096, 4096, 128)
    rng = np.random.default_rng(5)
    clouds = []
    for _ in range(B):
        c = np.stack([rng.integers(16, 4080, 700), rng.integers(16, 4080, 700),
                      rng.integers(16, 112, 700)], axis=1).astype(np.int32)
        clouds.append((c, rng.normal(size=(700, 5)).astype(np.float32)))
    return layout, clouds


@pytest.mark.parametrize("case", ["batch4", "partial2of4", "single",
                                  "int64_words", "session_output"])
def test_host_answers_equal_unbatch_and_coords(case):
    """The engine's one-read answer split gives, bitwise and with the
    same dtypes, each scene's ``unbatch()[i].features[:n]`` and
    ``coords()[0]`` (guard bias kept), also on int64 words (a layout whose
    batch field pushes the word past 31 bits) and on a session's
    level-1 output."""
    if case == "int64_words":
        layout, clouds = _int64_clouds(4)
        layout = layout.with_batch(4)
        assert layout.dtype == torch.int64
        k = 4
    else:
        layout, clouds = _clouds(4)
        k = {"batch4": 4, "partial2of4": 2, "single": 1,
             "session_output": 4}[case]
        layout = layout.with_batch(1 if case == "single" else 4)
        clouds = [(c, np.concatenate([f, f[:, :1]], axis=1))
                  for c, f in clouds[:k]]
    st = SparseTensor.from_point_clouds(clouds[:k], layout, device=CPU)
    if case == "session_output":
        sess = compile_network(_tiny_net(), layout, batch=4, min_bucket=128,
                               device=CPU)
        st = sess(SparseTensor.from_point_clouds(
            [(c, f[:, :4]) for c, f in clouds], sess.layout, device=CPU))
    got = host_answers(st, k)
    want = st.unbatch()[:k]
    assert len(got) == k
    for (logits, voxels), scene in zip(got, want):
        n = int(scene.count)
        ref_logits = scene.features.numpy()[:n]
        ref_voxels = scene.coords()[0]
        assert logits.dtype == ref_logits.dtype
        assert voxels.dtype == ref_voxels.dtype
        assert logits.shape == ref_logits.shape and n > 0
        np.testing.assert_array_equal(logits, ref_logits)
        np.testing.assert_array_equal(voxels, ref_voxels)


# ---------------------------------------------------------------------------
# one scenario through both packages' engines
# ---------------------------------------------------------------------------

def _scenario(pkg, session, clouds, layout, ck):
    """Poison, invalid coordinates, deadlines and 2x overload on a
    FakeClock: capacity 4 scenes / 0.1 s = 40/s, offered 80/s."""
    fs = pkg.FaultySession(session, delay=0.1, sleep=ck.sleep,
                           poison=pkg.feature_poison())
    eng = pkg.PointCloudServeEngine(
        fs, clock=ck, max_queue=8,
        admission=pkg.AdmissionConfig(target=0.05, interval=0.2),
        breaker=pkg.BreakerConfig(threshold=3, cooldown=0.3),
        ladder=pkg.LadderConfig(target=0.05, escalate_after=0.2,
                                deescalate_after=0.5, voxel_budget=1 << 20))
    reqs = pkg.make_traffic(clouds, 40, layout=layout, poison=(21, 34),
                            invalid=(26,),
                            deadlines={3: 0.01, 11: -1.0, 29: 0.45, 36: 0.5})
    rep = pkg.run_open_loop(
        eng, list(zip(pkg.arrival_times(40, rate=80.0), reqs)), ck,
        idle_tick=0.01)
    return eng, reqs, rep


# the port's front-door stages beneath the dispatch span: spans of the
# port's session that the reference's session does not record
PORT_STAGES = tuple(f"serve/dispatch/session/{s}" for s in (
    "admit", "call/", "replan/", "health", "finish"))


def _serve_entries(snap):
    return {kind: {k: v for k, v in entries.items()
                   if k.startswith("serve") and not k.startswith(PORT_STAGES)}
            for kind, entries in snap.items()}


def test_scenario_matches_the_jax_engine():
    """The same FakeClock scenario through ``repro.serve`` and
    ``repro_torch.serve`` with the same weights (``params_from_jax``):
    outcome sequence, counters and the LoadReport's outcomes, queue depth
    and rung equal; the ``serve*`` registry entries exactly equal, less the
    port's session stages beneath the dispatch span (``PORT_STAGES``); ``ok``
    logits within 1e-3 * max|ref| of JAX's and voxels exactly equal."""
    batch = jscenes.scene_batch(seed=7, batch=4, kind="indoor",
                                extent=(28, 24, 16), overlap=0.5)
    rng = np.random.default_rng(7)
    clouds = [(sc.coords,
               rng.normal(size=(len(sc.coords), 4)).astype(np.float32))
              for sc in batch]
    jl = batch[0].layout
    jspecs = (JSpec("l0", 4, 8, K=3, m_in=0, m_out=0, dataflow="ws"),
              JSpec("l1", 8, 8, K=3, m_in=0, m_out=1),
              JSpec("l2", 8, 8, K=3, m_in=1, m_out=1))
    jnet = JNet("tiny_scenario", jspecs, in_channels=4, n_classes=5)
    tnet = _tiny_net(ws=True, name="tiny_scenario")
    jparams = j_init(jax.random.key(0), jnet)

    jck = jserve.FakeClock()
    jreg = jobs.MetricsRegistry(clock=jck)
    jsess = jserve.compile_network(jnet, jl, params=jparams, batch=4,
                                   min_bucket=128, metrics=jreg)
    jeng, jreqs, jrep = _scenario(jserve, jsess, clouds, jl, jck)

    tl = BitLayout(**dataclasses.asdict(jl))
    tck = tserve.FakeClock()
    treg = MetricsRegistry(clock=tck)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tnet,
                              device=CPU)
    tsess = compile_network(tnet, tl, params=tparams, batch=4,
                            min_bucket=128, metrics=treg, device=CPU)
    teng, treqs, trep = _scenario(tserve, tsess, clouds, tl, tck)

    outcomes = [r.outcome for r in treqs]
    assert outcomes == [r.outcome for r in jreqs]
    assert {"ok", "shed", "quarantined", "invalid",
            "deadline_expired"} <= set(outcomes)
    assert teng.counters == jeng.counters
    assert trep.outcomes == jrep.outcomes
    assert trep.max_queue_depth == jrep.max_queue_depth
    assert trep.max_rung == jrep.max_rung >= 1
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)  # all
    assert _serve_entries(treg.snapshot()) == _serve_entries(jreg.snapshot())
    for i, (t, j) in enumerate(zip(treqs, jreqs)):
        assert t.degradation == j.degradation and t.error == j.error, i
        if t.outcome != "ok":
            assert t.logits is None
            continue
        ref = np.asarray(j.logits)
        np.testing.assert_array_equal(t.voxels, np.asarray(j.voxels))
        np.testing.assert_allclose(t.logits, ref, rtol=0,
                                   atol=1e-3 * float(np.abs(ref).max()),
                                   err_msg=f"request {i}")


# ---------------------------------------------------------------------------
# the serving examples, --smoke on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["torch_pointcloud_serve",
                                  "torch_robust_serve",
                                  "torch_overload_serve"])
def test_serving_example_smoke_on_cpu(name, capsys):
    mod = runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                         run_name="example")
    mod["main"](["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "✓" in out and "Traceback" not in out
