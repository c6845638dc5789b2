"""The port's spans (``repro_torch.obs.trace``) and the stages they record
in the front door and the trainer, on the CPU: a span opens a profiler
range only while a ``torch.profiler`` records, and then the profiler's
events hold the session's and the trainer's stages nested in
``session/call`` and ``train/step``; a span with no registry records into
its parent's; the histogram paths a call and a step leave; the registry
entries a call writes; and logits and trained parameters bitwise the same
with and without a profiler. One test runs on the card: under a CUDA
profiler, the benchmark's trace reader (``perfbench.lib.trace.read``)
keeps no program range among the device operations.
"""
import dataclasses
import sys
import threading
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.data import scenes
from repro_torch.models import pointcloud as tpc
from repro_torch.obs import MetricsRegistry, current_path, default_registry
from repro_torch.obs import span
from repro_torch.serve import PointCloudRequest, PointCloudServeEngine
from repro_torch.serve import compile_network
from repro_torch.serve import session as session_mod
from repro_torch.train import pointcloud as ttr
from repro_torch.train.guard import GuardConfig

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

CPU = "cpu"
EXTENT = (28, 24, 16)
N_CLASSES = 6

SESSION_STAGES = ["session/admit", "session/call", "session/call/load",
                  "session/call/replay", "session/call/read",
                  "session/health", "session/finish"]
STEP_STAGES = ["train/step/plan", "train/step/forward",
               "train/step/backward", "train/step/optimizer",
               "train/step/read"]


def _batch(seed=0, batch=2):
    return scenes.scene_batch(seed=seed, batch=batch, kind="indoor",
                              extent=EXTENT, labels=True,
                              n_classes=N_CLASSES)


def _session(net=None, seed=1, **kw):
    sb = _batch()
    net = net or tpc.tiny_segnet(in_channels=4, n_classes=N_CLASSES,
                                 width=8, depth=3)
    sess = compile_network(net, sb[0].layout, batch=2, seed=seed,
                           device=CPU, **kw)
    st, lab = ttr.labeled_batch(sb, sess.layout, device=CPU)
    return sess, st, lab


def _ranges(prof, prefixes=("session/", "train/", "serve/")):
    """The profiler's CPU ranges of the program: ``[(name, start, end)]``
    in nanoseconds, in start order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(prefixes)]
    return sorted(out, key=lambda r: r[1])


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _one(ranges, name):
    got = [r for r in ranges if r[0] == name]
    assert len(got) == 1, (name, [r[0] for r in ranges])
    return got[0]


# ---------------------------------------------------------------------------
# spans and the profiler
# ---------------------------------------------------------------------------

def test_span_opens_a_range_only_while_a_profiler_records():
    """No range with no profiler, nor in a scheduled profiler's warm-up; a
    range named by the span's path while one records."""
    reg = MetricsRegistry()
    with span("outer", reg) as s:
        assert s._range is None
    seen = []
    sched = schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=[ProfilerActivity.CPU], schedule=sched,
                 on_trace_ready=lambda p: None) as prof:
        for _ in range(2):
            with span("outer", reg) as s, span("inner") as t:
                seen.append((s._range is not None, t._range is not None))
            prof.step()
    assert seen == [(False, False), (True, True)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer", reg), span("inner"):
            pass
    names = [r[0] for r in _ranges(prof, ("outer",))]
    assert names == ["outer", "outer/inner"]
    assert reg.histogram("outer/inner").count == 3


def test_nested_span_without_registry_records_into_its_parent():
    """A span opened with no registry inside another on the same thread
    records into the parent's registry; at top level, and on another
    thread, it records nothing, in the default registry neither; so the
    trainer's loss closure called from a user's own loop leaves no bare
    ``plan`` or ``forward`` histogram."""
    reg = MetricsRegistry()
    before = default_registry().snapshot()["histograms"]
    with span("parent", reg):
        with span("child") as c:
            assert c.registry is reg and current_path() == "parent/child"
            with span("grandchild") as g:
                assert g.registry is reg

        def other():
            with span("stage_alone") as o:
                assert o.registry is None and o.path == "stage_alone"
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert current_path() == ""
    snap = reg.snapshot()["histograms"]
    assert set(snap) == {"parent", "parent/child",
                         "parent/child/grandchild"}
    with span("stage_alone") as o, span("inner") as i:
        assert o.registry is None and i.registry is None
        assert i.path == "stage_alone/inner"
    sess, st, lab = _session()
    loss_fn = ttr.make_segmentation_loss_fn(
        sess.net, sess.layout, engine=sess.engine, segment=sess.segment)
    loss_fn(sess.params, st.packed, st.features, lab)
    assert default_registry().snapshot()["histograms"] == before


def test_session_stages_nest_in_the_call_under_the_cpu_profiler():
    """A tiny eager CPU session: admit, then load, replay and read inside
    ``session/call`` in that order, then health and finish after it."""
    sess, st, _ = _session()
    sess(st)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess(st)
    r = _ranges(prof)
    assert [x[0] for x in r] == ["session/admit", "session/call",
                                 "session/call/load", "session/call/replay",
                                 "session/call/read", "session/health",
                                 "session/finish"]
    call = _one(r, "session/call")
    for stage in ("load", "replay", "read"):
        assert _within(_one(r, f"session/call/{stage}"), call)
    for stage in ("admit", "health", "finish"):
        s = _one(r, f"session/{stage}")
        assert s[2] <= call[1] or s[1] >= call[2]
    ends = [x[2] for x in r if x[0].count("/") == 1]
    starts = [x[1] for x in r if x[0].count("/") == 1]
    assert all(e <= s for e, s in zip(ends, starts[1:]))


@pytest.mark.parametrize("guarded", [False, True], ids=["plain", "guarded"])
def test_trainer_stages_nest_in_the_step_under_the_cpu_profiler(guarded):
    """A ``tiny_segnet`` step of either trainer: plan, forward, backward,
    optimizer and read inside ``train/step`` in that order, the pack
    before it."""
    sess, st, lab = _session()
    trainer = sess.compile_train(guard=GuardConfig() if guarded else None)
    trainer.step(st, lab)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.step(st, lab)
    r = _ranges(prof)
    assert [x[0] for x in r] == ["train/pack", "train/step"] + STEP_STAGES
    step = _one(r, "train/step")
    assert _one(r, "train/pack")[2] <= step[1]
    inner = [_one(r, name) for name in STEP_STAGES]
    assert all(_within(x, step) for x in inner)
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))


# ---------------------------------------------------------------------------
# what a call and a step leave in the registry
# ---------------------------------------------------------------------------

def test_session_histogram_paths_and_counters():
    """An eager call leaves the stage histograms, one sample each; the
    dropped pairs and overflowed window cells are two cumulative counters,
    with no per-layer gauge."""
    sess, st, _ = _session()
    for _ in range(3):
        sess(st)
    snap = sess.metrics.snapshot()
    assert sorted(snap["histograms"]) == sorted(SESSION_STAGES)
    assert all(h["count"] == 3 for h in snap["histograms"].values())
    assert snap["counters"]["session_runs"] == 3
    assert snap["counters"]["session_ws_dropped_pairs"] == 0
    assert snap["counters"]["plan_window_overflow_cells"] == 3 * sum(
        sess.last_health.window_overflow_cells.values())
    assert sorted(snap["gauges"]) == ["session_bucket", "session_escalation"]


def _replay_stand_in(monkeypatch):
    """The session's graph path on the CPU: ``capture`` runs the body once
    and returns a graph whose replay runs it again into the same outputs."""
    class Graph:
        def __init__(self, body):
            self.body, self.outputs = body, body()

        def pool(self):
            return None

        def replay(self):
            for out, new in zip(self.outputs, self.body()):
                out.copy_(new)

    def capture(body, device, pool=None):
        g = Graph(body)
        return g, g.outputs
    monkeypatch.setattr(session_mod, "capture", capture)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    monkeypatch.setattr(session_mod.SpiraSession, "_graphs",
                        property(lambda self: self.cuda_graphs))


def test_graph_session_records_capture_then_load(monkeypatch):
    """On the graph path a key's first call records ``capture`` in place of
    ``load``, later calls ``load``; every call ``replay`` and ``read``. No
    gauge holds the capture's seconds."""
    _replay_stand_in(monkeypatch)
    sess, st, _ = _session()
    eager, _, _ = _session(cuda_graphs=False)
    for _ in range(3):
        out = sess(st)
    ref = eager(st)
    assert torch.equal(out.features, ref.features)
    h = sess.metrics.snapshot()["histograms"]
    assert h["session/call/capture"]["count"] == 1
    assert h["session/call/load"]["count"] == 2
    assert h["session/call/replay"]["count"] == 3
    assert h["session/call/read"]["count"] == 3
    assert h["session/call"]["count"] == 3
    gauges = sess.metrics.snapshot()["gauges"]
    assert "session_graph_capture_seconds" not in gauges
    assert "session_graph_memory_reserved" in gauges


def test_replan_records_its_stages_under_session_replan():
    """A lossy WS net replans once: the second level's stages land under
    ``session/replan``, the health read once per level, and the counters
    sum what each call finally dropped (nothing)."""
    sb = _batch()
    net = tpc.tiny_segnet(in_channels=4, n_classes=N_CLASSES, width=8,
                          depth=3, dataflow="ws")
    probe = compile_network(net, sb[0].layout, batch=2, device=CPU)
    st, _ = ttr.labeled_batch(sb, probe.layout, device=CPU)
    cap = int(max(probe.plan(st).kmaps[s.name].column_counts().max()
                  for s in net.specs))
    lossy = dataclasses.replace(net, specs=tuple(
        dataclasses.replace(s, ws_capacity=(cap + 1) // 2)
        for s in net.specs))
    sess, st, _ = _session(lossy)
    _, health = sess.run_with_health(st)
    assert health.replans == 1 and health.ok
    h = sess.metrics.snapshot()["histograms"]
    for stage in ("load", "replay", "read"):
        assert h[f"session/call/{stage}"]["count"] == 1
        assert h[f"session/replan/{stage}"]["count"] == 1
    assert h["session/health"]["count"] == 2
    assert h["session/finish"]["count"] == 1
    c = sess.metrics.snapshot()["counters"]
    assert c["session_replans"] == 1 and c["session_ws_dropped_pairs"] == 0


@pytest.mark.parametrize("guarded", [False, True], ids=["plain", "guarded"])
def test_trainer_histogram_paths(guarded):
    """A step leaves ``train/pack``, ``train/step`` and the five stages in
    the session's registry, one sample each a step, and nothing in the
    default registry."""
    sess, st, lab = _session()
    trainer = sess.compile_train(guard=GuardConfig() if guarded else None)
    before = set(default_registry().snapshot()["histograms"])
    for _ in range(2):
        trainer.step(st, lab)
    h = sess.metrics.snapshot()["histograms"]
    assert sorted(h) == sorted(["train/pack", "train/step"] + STEP_STAGES)
    assert all(v["count"] == 2 for v in h.values())
    assert set(default_registry().snapshot()["histograms"]) == before


def test_engine_dispatch_holds_the_session_stages():
    """Under ``PointCloudServeEngine`` the session's stages land beneath
    ``serve/dispatch`` (no watchdog: the call runs on the engine's
    thread)."""
    sess, _, _ = _session()
    sb = _batch(seed=3, batch=4)
    reqs = [PointCloudRequest(sc.coords, ttr.scene_features(sc))
            for sc in sb]
    PointCloudServeEngine(sess, max_batch=2).run(reqs)
    assert all(r.outcome == "ok" for r in reqs)
    h = sess.metrics.snapshot()["histograms"]
    for name in SESSION_STAGES:
        assert h[f"serve/dispatch/{name}"]["count"] == 2, name


# ---------------------------------------------------------------------------
# a profiler changes no result
# ---------------------------------------------------------------------------

def test_logits_bitwise_equal_with_and_without_a_profiler():
    sess, st, _ = _session()
    plain = sess(st)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = sess(st)
    assert torch.equal(plain.features, traced.features)
    assert torch.equal(plain.packed, traced.packed)


@pytest.mark.parametrize("guarded", [False, True], ids=["plain", "guarded"])
def test_train_step_bitwise_equal_with_and_without_a_profiler(guarded):
    """Two trainers from the same weights take two steps, one of them under
    a profiler: the parameters and metrics are bitwise equal."""
    out = []
    for traced in (False, True):
        sess, st, lab = _session()
        trainer = sess.compile_train(
            guard=GuardConfig() if guarded else None)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                m = [trainer.step(st, lab) for _ in range(2)]
        else:
            m = [trainer.step(st, lab) for _ in range(2)]
        out.append((m, {k: v.detach().clone()
                        for k, v in sess.params.named_parameters()}))
    (m0, p0), (m1, p1) = out
    assert m0 == m1
    assert p0.keys() == p1.keys()
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


# ---------------------------------------------------------------------------
# on the card: the benchmark's reader keeps program ranges off the device
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the session's kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_trace_keeps_program_ranges_off_the_device_ops(card):
    """A graph session's calls and an eager training step under a CUDA
    profiler, inside the benchmark's window range: the trace reader's
    device operations hold no program range, and the profiler's host
    events hold every stage."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from perfbench.lib import trace
    sb = _batch()
    net = tpc.tiny_segnet(in_channels=4, n_classes=N_CLASSES, width=16)
    sess = compile_network(net, sb[0].layout, batch=2, device=card)
    st, lab = ttr.labeled_batch(sb, sess.layout, device=CPU)
    trainer = ttr.PointCloudTrainer(
        compile_network(net, sb[0].layout, batch=2, device=card,
                        cuda_graphs=False))
    sess(st)
    trainer.step(st, lab)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench/window"):
            for _ in range(3):
                sess(st)
            trainer.step(st, lab)
            torch.cuda.synchronize()
    tr = trace.read(prof)
    assert tr.ops, "the trace holds no device operation"
    program = ("session/", "train/")
    assert not [n for n, _, _ in tr.ops if n.startswith(program)]
    names = {r[0] for r in _ranges(prof)}
    assert set(SESSION_STAGES) <= names
    assert set(STEP_STAGES) <= names
