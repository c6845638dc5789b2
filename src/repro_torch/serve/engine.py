"""Batched serving engines: point-cloud request batching + LM slot batching
(torch port of ``repro.serve.engine``).

Two engines share the plan-ahead philosophy (static shapes, precomputed
indexing/caches, zero per-request compilation):

* :class:`PointCloudServeEngine` — the SpC serving loop the paper's
  "inference engine" framing asks for: per-scene requests queue up, get
  packed into batched :class:`SparseTensor`s (scene index in the layout's
  batch bits), run through ONE :class:`SpiraSession` call, and are
  answered with per-scene logits. Capacity bucketing (inside the session)
  keeps the number of distinct compile keys at one per bucket —
  scene-size variance never adds one.

* :class:`ServeEngine` — slot-based continuous batching for the LM
  architectures: a fixed pool of B slots shares one decode step;
  requests claim a free slot, prefill into its cache region, then join the
  shared per-step decode batch; finished slots recycle.

Degraded-mode contract (PointCloudServeEngine)
----------------------------------------------
A request admitted to the engine always reaches exactly ONE terminal
``outcome``; no exception from one request's data, one batch's execution,
or the traffic level ever propagates through
:meth:`~PointCloudServeEngine.step` / :meth:`~PointCloudServeEngine.run`
or takes a co-batched request down with it:

* ``"ok"`` — served; ``logits`` / ``voxels`` hold the answer and (because a
  batch-of-B session call is bitwise identical to B single-scene calls) the
  answer never depends on which requests it was batched with — even when a
  co-batched request was faulty and the batch was bisected, and even when
  the engine was running degraded (rungs below): a healthy-scene request is
  bitwise identical to the same request in an unloaded run.
* ``"invalid"`` — the scene failed ingest validation
  (``core.validate``; the engine packs with its ``validate=`` policy and
  uses ``ValidationError.scene_index`` to exclude exactly the offending
  scene, then serves the rest).
* ``"quarantined"`` — the session failed deterministically for every batch
  containing this request (after transient retries); isolated by bisection:
  the failing batch is split in halves and retried until the poisoned
  request stands alone, so B−1 innocent requests still get their exact
  answers.
* ``"shed"`` — admission control refused the request at submit time:
  either the bounded queue (``max_queue``, the hard backstop) was full, or
  the adaptive controller (``admission=``,
  :class:`~repro_torch.serve.scheduler.AdmissionController` — CoDel on
  observed queue delay) was shedding. Never enters the queue;
  ``counters["admission_shed"]`` separates the adaptive sheds from the
  backstop's.
* ``"deadline_expired"`` — the request's ``deadline`` (engine-clock units)
  passed before dispatch. Checked at submit time (a dead-on-arrival
  request never occupies the queue), at every queue expiry sweep
  (:meth:`step` excises doomed requests from the whole queue before any
  device work — a dead request can no longer hold the ``max_wait``
  partial-batch timer hostage), and at drain time.
* ``"rejected_open"`` — the circuit breaker (``breaker=``,
  :class:`~repro_torch.serve.scheduler.CircuitBreaker`) was open: a recent
  run of consecutive non-transient dispatch failures means the session is
  presumed wedged, so the batch is failed fast — no pack, no device work,
  no retry burn. After ``cooldown`` one half-open probe batch tests the
  session; success re-closes the breaker.
* ``"dispatch_timeout"`` — the dispatch watchdog (``dispatch_timeout=``
  seconds, REAL time — a hung call cannot be observed on an injectable
  clock) gave up waiting on a session call. Non-transient by construction
  (no retry, no bisection — the hang says nothing about which request is
  at fault); counts as a breaker failure.

Degradation ladder (``ladder=``,
:class:`~repro_torch.serve.scheduler.DegradationLadder`): under sustained
queue delay above target the engine trades quality/latency headroom for
survival, one rung at a time — rung 1 tightens the caller's ``max_wait``
by ``max_wait_factor``; rung 2 disables WS-overflow replan escalation
(serves with ``HealthReport`` drops flagged instead of burning replans:
``run_with_health(st, max_replans=0)``); rung 3 decimates scenes over
``voxel_budget`` input points at pack time (deterministic even-stride
subsample; ``req.downsampled`` marks the answer as approximate). Rungs
step back down after the delay has stayed under target for
``deescalate_after``. Every served request records the rung it was packed
under (``req.degradation``); the current rung is the
``serve_degradation_rung`` gauge.

Transient session failures (classified by the injectable ``transient``
predicate; by default :class:`repro_torch.serve.faults.TransientError`,
``torch.cuda.OutOfMemoryError`` and messages mentioning ``UNAVAILABLE`` /
``RESOURCE_EXHAUSTED``) are retried up to ``max_retries`` times with
exponential backoff capped at ``backoff_cap`` (injectable ``sleep``)
before bisection treats them as deterministic. Every decision increments
a counter exported by :attr:`~PointCloudServeEngine.counters` — the
observability surface the fault-injection suite
(``tests/test_torch_serve_faults.py``) and the overload suite
(``tests/test_torch_serve_overload.py``) assert against. Session
degradation (WS pair drops, escalation replans —
``serve.session.HealthReport``) rides on each request's ``health`` and
aggregates into ``counters["overflow_replans"]``.

Queue discipline (``scheduler=``): ``"fifo"`` (default — the single
arrival-ordered queue) or ``"bucket"``
(:class:`~repro_torch.serve.scheduler.BucketScheduler` — one queue per
pow2 capacity bucket, batches are bucket-homogeneous and dispatched
independently per bucket, earliest-deadline-first within a bucket). See
``serve.scheduler``'s module doc; ``serve.loadgen`` replays whole
overload scenarios deterministically on a FakeClock.

On the card
-----------
* Packing is host work: the engine packs every batch on the host
  (``device="cpu"``, numpy sort and dedup) and the session moves it to its
  device in one copy. The serial :meth:`step` and the pack-ahead
  :meth:`run` pack the same way, so their answers are the same bits.
* Answers are read once per batch: the logits, packed words and count come
  to the host together and are split there by the batch field
  (:func:`host_answers`), not scene by scene through ``unbatch()``.
* The dispatch watchdog's thread enters the session's CUDA device (a new
  thread starts on device 0). An abandoned call's kernels stay queued on
  the card, and the next dispatch waits behind them.
* Which CUDA faults are transient: ``torch.cuda.OutOfMemoryError`` is the
  counterpart of XLA's ``RESOURCE_EXHAUSTED`` and is retried. Every other
  CUDA error (an illegal address poisons the context) is non-transient:
  it goes to bisection and the breaker, as any non-transient error does.

Metrics (the contract's observability surface, ``repro_torch.obs``)
-------------------------------------------------------------------
The engine writes to one :class:`~repro_torch.obs.MetricsRegistry` — by
default the session's (so plan/serve/train share a surface), overridable
via the ``metrics=`` argument. The degraded-mode counters above ARE
registry counters (``serve_<name>``): the plain-int attributes
(``eng.shed``) and the ``counters`` dict are live views over the registry,
so the two can never disagree, and ``+=`` / ``=`` on them keeps working.
On top of the counters the engine records:

* ``serve_queue_wait`` histogram — submit→drain time per request;
* ``serve/pack`` / ``serve/dispatch`` histograms — host pack time and
  per-attempt session-call time (``obs.trace.span``, host side only —
  never inside a kernel wrapper, see ``repro_torch.obs.trace``); under the
  watchdog the session's own span runs on the watchdog's thread and
  records as ``session/call``, not ``serve/dispatch/session/call``;
* ``serve_latency_<outcome>`` histograms — submit→terminal-outcome
  latency, one histogram per outcome so SLO percentiles aren't polluted
  by shed/expired requests;
* ``serve_qps`` rolling rate — scenes served over the trailing 60 s;
* ``serve_queue_depth`` gauge — queue length after each admit/drain;
* ``serve_breaker_state`` gauge — 0 closed / 1 half-open / 2 open
  (only when a breaker is configured);
* ``serve_degradation_rung`` gauge — current ladder rung (only when a
  ladder is configured).

Instrumentation is observational only: engine answers stay bitwise
identical to an uninstrumented run, and session compile/search counts are
unchanged (pinned in tests/test_torch_serve_engine.py).

LM serving
----------
The port of ``Request`` and ``ServeEngine`` with the slot logic unchanged:
a request claims a free slot, is prefilled alone (one
``transformer.prefill``, which runs the flash attention kernel on the
card) into that slot's cache region, then joins the shared per-step
decode batch over all B slots; a finished slot returns to the pool.
Greedy requests (``temperature <= 0``) take the argmax of the logits, as
the reference does. Sampled ones draw from ``softmax(logits /
temperature)`` with the engine's ``torch.Generator`` (seeded by ``seed``):
the same distribution as the reference's ``jax.random.categorical``, not
the same numbers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.packing import unpack
from ..core.sparse_tensor import SparseTensor
from ..core.validate import ValidationError
from ..models import transformer as tf
from ..models.common import ModelConfig
from ..obs import CounterView, MetricsRegistry, span
from .faults import TransientError
from .scheduler import (AdmissionConfig, AdmissionController, BreakerConfig,
                        BucketScheduler, CircuitBreaker, DegradationLadder,
                        DispatchTimeoutError, FifoScheduler, LadderConfig)


# ---------------------------------------------------------------------------
# point-cloud serving: request queue over a compiled SpiraSession
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)   # identity semantics: a request is a
                                   # ticket, not a value (and ndarray
                                   # fields break the generated __eq__)
class PointCloudRequest:
    """One scene in, per-voxel logits out.

    ``coords`` are guard-biased integer voxels [N, 3] (data-pipeline space,
    same contract as ``data.scenes``), ``features`` the aligned [N, C] rows.
    After serving, ``logits`` [n, n_classes] and ``voxels`` [n, 3] hold the
    answer on the scene's rows of the network's OUTPUT-level coordinate set:
    for a segmentation net ending at level 0 (e.g. minkunet42) that is the
    scene's sorted deduplicated input voxels (n <= N); for a net ending at a
    coarser level (e.g. sparse_resnet21, level 3) it is the scene's
    downsampled stride-2^m voxels — n can be far smaller than N.
    """

    coords: np.ndarray
    features: np.ndarray
    logits: Optional[np.ndarray] = None
    voxels: Optional[np.ndarray] = None
    done: bool = False
    # fault-isolation surface (module doc, "Degraded-mode contract"):
    deadline: Optional[float] = None   # engine-clock time after which the
                                       # request is dropped unserved
    outcome: str = "pending"           # "ok" | "invalid" | "quarantined" |
                                       # "shed" | "deadline_expired" |
                                       # "rejected_open" | "dispatch_timeout"
    error: Optional[str] = None        # structured message for non-ok ends
    health: Optional[object] = None    # serve.session.HealthReport when the
                                       # session exports one
    submitted_at: Optional[float] = None   # engine clock at submit; feeds
                                           # the per-outcome latency
                                           # histograms (module doc)
    degradation: int = 0               # ladder rung this request was packed
                                       # under (0 = healthy engine)
    downsampled: bool = False          # rung 3 decimated this scene to the
                                       # voxel budget: answer is approximate

    @property
    def finished(self) -> bool:
        """Terminal (served OR failed) — the engine will not touch it again."""
        return self.outcome != "pending"


def _default_transient(e: BaseException) -> bool:
    """Default transient-fault classifier: the harness's TransientError,
    CUDA's out-of-memory error (the counterpart of XLA's
    RESOURCE_EXHAUSTED), and the gRPC-style status names real runtimes put
    in message text. Every other CUDA error is non-transient (module doc,
    "On the card")."""
    return (isinstance(e, (TransientError, torch.cuda.OutOfMemoryError))
            or "UNAVAILABLE" in str(e) or "RESOURCE_EXHAUSTED" in str(e))


def host_answers(out: SparseTensor, scenes: int
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-scene ``(logits [n, C], voxels [n, 3])`` of the first ``scenes``
    scene slots of a batched session output, read to the host once: the
    count, then the valid prefix of the packed words and of the logits,
    split on the host by the batch field (the words are batch-major
    sorted, so scene i's rows are one contiguous segment). Bitwise what
    ``out.unbatch()`` gives as each scene's ``features[:n]`` and
    ``coords()[0]`` — the guard bias kept — without a device round trip
    per scene."""
    n = int(out.count)
    logits = out.features[:n].cpu().numpy()
    voxels, sid = unpack(out.packed[:n].cpu(), out.layout)
    voxels, sid = voxels.numpy(), sid.numpy()
    edges = np.searchsorted(sid, np.arange(scenes + 1), side="left")
    return [(logits[a:b], voxels[a:b])
            for a, b in zip(edges[:-1], edges[1:])]


def _cuda_index(device) -> Optional[int]:
    """The CUDA device index a session on ``device`` runs on, resolved in
    the calling thread (a bare ``"cuda"`` is the caller's current
    device); None off the card."""
    if device is None or torch.device(device).type != "cuda":
        return None
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


class PointCloudServeEngine:
    """Queue per-scene requests, answer them in batched session calls.

    >>> session = compile_network(net, layout, batch=4)
    >>> eng = PointCloudServeEngine(session)
    >>> eng.run(requests)          # or submit() + step() for a live loop

    Each :meth:`step` drains up to ``session.num_scenes`` requests, packs
    them into one batched SparseTensor via the session's layout, runs the
    session once, and scatters per-scene logits back onto the requests.
    A partially full batch is fine (unused scene slots simply don't occur
    in the coordinate set); a single request still gets a correct answer.

    Latency bail-out: a live serving loop wants to hold a partial batch
    briefly hoping more requests arrive (batching amortizes dispatch), but
    never longer than its latency budget. ``step(max_wait=s)`` implements
    that policy: it dispatches immediately once the batch is full, holds
    (returns ``[]``) while the *oldest* queued request has waited less than
    ``s`` seconds, and dispatches the partial batch as soon as it has —
    a lone request is answered within the bound instead of blocking forever
    on a batch that will never fill. ``max_wait=None`` keeps the legacy
    dispatch-whatever-is-queued behavior.

    Pack/execute overlap: host-side packing
    (``SparseTensor.from_point_clouds`` — one sort + dedup per scene) is
    the serving loop's main host cost, and it needs nothing from the
    device: the engine packs on the host (``device="cpu"``) and the session
    moves the batch to its device. With ``pack_ahead=True``, :meth:`run`
    pipelines it: batch t+1 is packed on a single worker thread while
    batch t executes on the device (the main thread blocks inside the
    session call, whose health reads synchronize, and the worker's numpy
    sort and dedup run in that window). Answers are identical to the
    serial path (parity-tested); ``packs_overlapped`` counts packs that
    completed while their predecessor batch executed — i.e. were FULLY
    hidden (a pack still in flight when results are materialized would
    make the main thread wait and is not counted).
    """

    # Registry-backed counters (module doc, "Metrics"): plain-int attribute
    # surface over `self.metrics` counters. `__init__` zeroes them, so an
    # engine's counts are its own even on a shared registry — two engines
    # sharing one registry is not a supported aggregation scheme.
    batches_run = CounterView("serve_batches_run")
    scenes_served = CounterView("serve_scenes_served")
    packs_overlapped = CounterView("serve_packs_overlapped")
    admitted = CounterView("serve_admitted")
    shed = CounterView("serve_shed")
    invalid = CounterView("serve_invalid")
    quarantined = CounterView("serve_quarantined")
    deadline_expired = CounterView("serve_deadline_expired")
    retries = CounterView("serve_retries")
    overflow_replans = CounterView("serve_overflow_replans")
    # overload-control counters (module doc, "Degraded-mode contract")
    rejected_open = CounterView("serve_rejected_open")
    dispatch_timeouts = CounterView("serve_dispatch_timeouts")
    admission_shed = CounterView("serve_admission_shed")
    breaker_trips = CounterView("serve_breaker_trips")
    downsampled = CounterView("serve_downsampled")
    degradations = CounterView("serve_degradations")

    def __init__(self, session, max_batch: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 pack_ahead: bool = False,
                 max_queue: Optional[int] = None,
                 validate: str = "reject",
                 max_retries: int = 2,
                 backoff: float = 0.01,
                 backoff_cap: float = 0.5,
                 sleep: Callable[[float], None] = time.sleep,
                 transient: Optional[Callable[[BaseException], bool]] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 scheduler="fifo",
                 admission=None,
                 breaker=None,
                 ladder=None,
                 dispatch_timeout: Optional[float] = None):
        # Duck-typed: a compiled SpiraSession or anything shaped like one
        # (callable, with layout/num_scenes) — the fault-injection wrapper
        # serve.faults.FaultySession drops in here.
        if not (callable(session) and hasattr(session, "layout")
                and hasattr(session, "num_scenes")):
            raise TypeError(
                f"PointCloudServeEngine drives a compiled SpiraSession (or a "
                f"duck-typed wrapper with layout/num_scenes), got "
                f"{type(session).__name__}; build one with "
                "repro_torch.serve.compile_network(net, layout, "
                "batch=B).")
        self.session = session
        # One registry across plan → serve: prefer the caller's, then the
        # session's, else a private one on the engine clock. Must exist
        # before the CounterView zeroing below.
        self.metrics = (metrics
                        or getattr(session, "metrics", None)
                        or MetricsRegistry(clock=clock))
        self.max_batch = min(max_batch or session.num_scenes,
                             session.num_scenes)
        # queue discipline (module doc): "fifo" | "bucket" | instance
        if scheduler == "fifo":
            self._sched = FifoScheduler()
        elif scheduler == "bucket":
            self._sched = BucketScheduler(
                min_bucket=getattr(session, "min_bucket", 1024),
                max_bucket=getattr(session, "max_bucket", None))
        else:
            self._sched = scheduler
        # overload policies: config-or-instance, None = off (legacy behavior)
        self._admission = (AdmissionController(admission)
                           if isinstance(admission, AdmissionConfig)
                           else admission)
        self._breaker = (CircuitBreaker(breaker)
                         if isinstance(breaker, BreakerConfig) else breaker)
        self._ladder = (DegradationLadder(ladder)
                        if isinstance(ladder, LadderConfig) else ladder)
        self.dispatch_timeout = dispatch_timeout   # REAL seconds (watchdog)
        self._clock = clock                      # injectable for tests
        self._sleep = sleep                      # injectable for tests
        self.pack_ahead = pack_ahead
        self.max_queue = max_queue               # None = unbounded backstop
        self.validate = validate                 # ingest policy (core.validate)
        self.max_retries = max_retries
        self.backoff = backoff
        self.backoff_cap = backoff_cap
        self._transient = transient or _default_transient
        self.batches_run = 0
        self.scenes_served = 0
        self.packs_overlapped = 0
        # degraded-mode counters (module doc) — the observability surface
        self.admitted = 0
        self.shed = 0
        self.invalid = 0
        self.quarantined = 0
        self.deadline_expired = 0
        self.retries = 0
        self.overflow_replans = 0
        self.rejected_open = 0
        self.dispatch_timeouts = 0
        self.admission_shed = 0
        self.breaker_trips = 0
        self.downsampled = 0
        self.degradations = 0
        if self._breaker is not None:
            self._sync_breaker()
        if self._ladder is not None:
            self.metrics.gauge("serve_degradation_rung").set(self._ladder.rung)

    @property
    def pending(self):
        """The queue discipline (``len()`` / truthiness = queued requests)."""
        return self._sched

    @property
    def degradation_rung(self) -> int:
        """Current ladder rung (0 when no ladder is configured)."""
        return self._ladder.rung if self._ladder is not None else 0

    @property
    def counters(self) -> Dict[str, int]:
        """The degraded-mode counters as one dict (for metrics export)."""
        return {k: getattr(self, k) for k in (
            "admitted", "shed", "invalid", "quarantined", "deadline_expired",
            "retries", "overflow_replans", "batches_run", "scenes_served",
            "packs_overlapped", "rejected_open", "dispatch_timeouts",
            "admission_shed", "breaker_trips", "downsampled", "degradations")}

    def submit(self, req: PointCloudRequest) -> bool:
        """Admit a request, or finalize it unadmitted: ``deadline_expired``
        when it is dead on arrival, ``shed`` when the adaptive admission
        controller is shedding or the bounded queue (the hard backstop) is
        full. Returns whether the request was admitted."""
        now = self._clock()
        req.submitted_at = now
        if req.deadline is not None and now > req.deadline:
            # submit-time expiry: dead on arrival — never occupies the queue
            self._finish(req, "deadline_expired",
                         f"deadline {req.deadline:.3f} already passed at "
                         f"submit time {now:.3f}")
            self.deadline_expired += 1
            return False
        if (self._admission is not None
                and not self._admission.offer(now, len(self._sched))):
            self._finish(req, "shed",
                         "admission control: standing queue delay above "
                         "target; retry later")
            self.admission_shed += 1
            self.shed += 1
            return False
        if self.max_queue is not None and len(self._sched) >= self.max_queue:
            self._finish(req, "shed",
                         f"queue full ({self.max_queue} pending); retry later")
            self.shed += 1
            return False
        self._sched.push(req, now)
        self.admitted += 1
        self.metrics.gauge("serve_queue_depth").set(len(self._sched))
        return True

    # -- batch plumbing (shared by the serial step and the pipelined run) --

    def _finish(self, req: PointCloudRequest, outcome: str,
                error: str) -> None:
        req.outcome = outcome
        req.error = error
        self._record_latency(req)

    def _record_latency(self, req: PointCloudRequest) -> None:
        """Submit→terminal latency into the per-outcome histogram."""
        if req.submitted_at is not None:
            self.metrics.histogram(f"serve_latency_{req.outcome}").record(
                self._clock() - req.submitted_at)

    def _expire_queue(self, now: float) -> List[PointCloudRequest]:
        """Excise every queued request whose deadline has passed — from the
        WHOLE queue, not just the drain prefix — and finalize them. Runs
        before any device work is spent and before the ``max_wait`` hold
        check, so a dead request can neither ride into a pack nor keep the
        partial-batch timer alive."""
        expired = []
        for req, at in self._sched.expire(now):
            self._finish(req, "deadline_expired",
                         f"deadline {req.deadline:.3f} passed at "
                         f"{now:.3f} (queued at {at:.3f})")
            self.deadline_expired += 1
            expired.append(req)
        if expired:
            self.metrics.gauge("serve_queue_depth").set(len(self._sched))
        return expired

    def _observe_wait(self, wait: float, now: float) -> None:
        """Feed one queue-wait sample to the overload controllers."""
        self.metrics.histogram("serve_queue_wait").record(wait)
        if self._admission is not None:
            self._admission.observe(wait, now)
        if self._ladder is not None:
            prev = self._ladder.rung
            rung = self._ladder.observe(wait, now)
            if rung != prev:
                if rung > prev:
                    self.degradations += 1
                self.metrics.gauge("serve_degradation_rung").set(rung)

    def _drain_batch(self) -> Tuple[List[PointCloudRequest], List[float],
                                    List[PointCloudRequest]]:
        """Expire doomed requests queue-wide, then pop the next batch per
        the queue discipline (FIFO, or one bucket in EDF order). Returns
        ``(batch, arrivals, expired)``; each drained request is stamped
        with the active degradation rung."""
        now = self._clock()
        expired = self._expire_queue(now)
        batch, arrivals = self._sched.drain(now, self.max_batch)
        for req, at in zip(batch, arrivals):
            self._observe_wait(now - at, now)
            req.degradation = self.degradation_rung
        if batch:
            self.metrics.gauge("serve_queue_depth").set(len(self._sched))
        return batch, arrivals, expired

    def _downsample(self, batch: List[PointCloudRequest]) -> None:
        """Rung 3: decimate scenes over the voxel budget to exactly the
        budget with a deterministic even-stride subsample (strictly
        increasing indices — budget < N means the stride exceeds 1, so no
        row repeats). The request keeps its answer shape contract (logits
        on ITS packed rows), just on fewer input points."""
        budget = self._ladder.config.voxel_budget
        for r in batch:
            if len(r.coords) > budget and not r.downsampled:
                idx = np.linspace(0, len(r.coords) - 1, budget).astype(int)
                r.coords = r.coords[idx]
                r.features = r.features[idx]
                r.downsampled = True
                self.downsampled += 1

    def _pack(self, batch: List[PointCloudRequest]) -> SparseTensor:
        """Pack on the host; the session moves the batch to its device."""
        if self._ladder is not None and self._ladder.rung >= 3:
            self._downsample(batch)
        with span("serve/pack", self.metrics):
            return SparseTensor.from_point_clouds(
                [(r.coords, r.features) for r in batch], self.session.layout,
                validate=self.validate, device="cpu")

    def _answer(self, batch: List[PointCloudRequest], out, health) -> None:
        """Scatter per-scene logits back onto the requests: the batch's
        results are read to the host once and split there
        (:func:`host_answers`)."""
        for req, (logits, voxels) in zip(batch,
                                         host_answers(out, len(batch))):
            req.logits = logits
            req.voxels = voxels
            req.health = health
            req.done = True
            req.outcome = "ok"
            self._record_latency(req)
        self.metrics.rate("serve_qps").mark(len(batch))
        if health is not None:
            self.overflow_replans += health.replans
        self.batches_run += 1
        self.scenes_served += len(batch)

    # -- fault isolation (module doc, "Degraded-mode contract") ----------

    def _invoke_session(self, st: SparseTensor):
        """The raw session call, with the rung-2 degradation applied:
        under ``no_escalation`` the session serves at its base plan with
        ``max_replans=0`` — WS drops are flagged on the HealthReport
        instead of cured by replans (latency headroom over exactness)."""
        if hasattr(self.session, "run_with_health"):
            if self._ladder is not None and self._ladder.rung >= 2:
                return self.session.run_with_health(st, max_replans=0)
            return self.session.run_with_health(st)
        return self.session(st), None

    def _watched(self, st: SparseTensor):
        """Dispatch under the watchdog: the session call runs on a daemon
        thread and we wait at most ``dispatch_timeout`` REAL seconds for
        it (an injectable clock cannot observe a hang — nothing would
        advance it). On timeout the call is abandoned (daemon thread: it
        cannot block interpreter exit; its kernels stay queued and the next
        dispatch waits behind them) and DispatchTimeoutError raised. The
        thread enters the session's CUDA device; the session's own
        ``no_grad`` covers the per-thread gradient mode."""
        if self.dispatch_timeout is None:
            return self._invoke_session(st)
        box: dict = {}
        done = threading.Event()
        # a new thread starts on CUDA device 0: enter the session's
        index = _cuda_index(getattr(self.session, "device", None))

        def work():
            try:
                with (torch.cuda.device(index) if index is not None
                      else contextlib.nullcontext()):
                    box["out"] = self._invoke_session(st)
            except BaseException as e:
                box["exc"] = e
            finally:
                done.set()

        threading.Thread(target=work, daemon=True).start()
        if not done.wait(self.dispatch_timeout):
            raise DispatchTimeoutError(
                f"session dispatch exceeded the {self.dispatch_timeout}s "
                f"watchdog (batch of {int(st.num_scenes)} scene slots)")
        if "exc" in box:
            raise box["exc"]
        return box["out"]

    def _call_session(self, st: SparseTensor):
        """One session call with capped-backoff retry of transient faults.
        Raises only after ``max_retries`` transient failures (or on the
        first non-transient one) — bisection takes over from there. A
        watchdog timeout is never retried: a hung call burns another full
        timeout and says nothing bisection could use."""
        attempt = 0
        while True:
            try:
                with span("serve/dispatch", self.metrics):
                    return self._watched(st)
            except Exception as e:
                if (isinstance(e, DispatchTimeoutError)
                        or not self._transient(e)
                        or attempt >= self.max_retries):
                    raise
                self.retries += 1
                self._sleep(min(self.backoff * (2 ** attempt),
                                self.backoff_cap))
                attempt += 1

    def _serve_batch(self, batch: List[PointCloudRequest]) -> None:
        """Pack + dispatch with full fault isolation; never raises.

        Ingest rejections are attributed exactly (``ValidationError.scene_index``),
        the offending request finalized as ``invalid``, and the remainder
        re-packed; un-attributable failures go through :meth:`_dispatch`'s
        bisection."""
        if not batch:
            return
        try:
            st = self._pack(batch)
        except ValidationError as e:
            idx = e.scene_index if e.scene_index is not None else 0
            bad = batch[idx]
            self._finish(bad, "invalid", str(e))
            self.invalid += 1
            self._serve_batch(batch[:idx] + batch[idx + 1:])
            return
        except Exception as e:
            self._isolate(batch, e, "invalid")
            return
        self._dispatch(batch, st)

    def _sync_breaker(self) -> None:
        self.metrics.gauge("serve_breaker_state").set(
            {"closed": 0, "half_open": 1, "open": 2}[self._breaker.state])

    def _breaker_failure(self) -> None:
        if self._breaker is None:
            return
        if self._breaker.record_failure(self._clock()):
            self.breaker_trips += 1
        self._sync_breaker()

    def _dispatch(self, batch: List[PointCloudRequest],
                  st: SparseTensor) -> None:
        """Run one packed batch; on persistent failure bisect down to the
        poisoned request. Never raises. Gated by the circuit breaker
        (batches fail fast as ``rejected_open`` while it is open); a
        watchdog timeout fails the whole batch as ``dispatch_timeout``
        (no bisection — the hang attributes to no request) and feeds the
        breaker."""
        if self._breaker is not None:
            allowed = self._breaker.allow(self._clock())
            self._sync_breaker()
            if not allowed:
                for req in batch:
                    self._finish(req, "rejected_open",
                                 f"circuit breaker open after "
                                 f"{self._breaker.config.threshold} "
                                 f"consecutive dispatch failures; "
                                 f"retry after cooldown")
                    self.rejected_open += 1
                return
        try:
            out, health = self._call_session(st)
        except DispatchTimeoutError as e:
            for req in batch:
                self._finish(req, "dispatch_timeout", str(e))
                self.dispatch_timeouts += 1
            self._breaker_failure()
            return
        except Exception as e:
            self._breaker_failure()
            self._isolate(batch, e, "quarantined")
            return
        if self._breaker is not None:
            self._breaker.record_success()
            self._sync_breaker()
        self._answer(batch, out, health)

    def _isolate(self, batch: List[PointCloudRequest], exc: BaseException,
                 outcome: str) -> None:
        """Bisection quarantine: a failing batch splits into halves, each
        re-packed and re-served; repeated splitting corners a deterministic
        fault on exactly the request carrying it, while every innocent
        request is served from a smaller batch — bitwise identical to a
        clean run, by the session's batched-bit-identity contract."""
        if len(batch) == 1:
            self._finish(batch[0], outcome,
                         f"{type(exc).__name__}: {exc}")
            if outcome == "quarantined":
                self.quarantined += 1
            else:
                self.invalid += 1
            return
        mid = len(batch) // 2
        self._serve_batch(batch[:mid])
        self._serve_batch(batch[mid:])

    # -- serving loops ----------------------------------------------------

    def step(self, max_wait: Optional[float] = None
             ) -> List[PointCloudRequest]:
        """Serve one batch (up to ``max_batch`` queued requests). Returns
        every request finalized this step (served, failed, or expired).

        ``max_wait``: hold a partial batch (serve nothing) until the oldest
        queued LIVE request has waited this many seconds, then dispatch
        whatever is queued (class doc). ``None`` dispatches immediately.
        Already-expired requests are excised and finalized BEFORE the hold
        check, so a dead request neither keeps the timer alive nor counts
        toward the batch; expiring the whole queue just returns the expired
        requests. Under ladder rung ≥ 1 the hold is tightened to
        ``max_wait * max_wait_factor``."""
        if not self._sched:
            return []
        now = self._clock()
        expired = self._expire_queue(now)
        if not self._sched:          # everything queued had expired
            return expired
        if max_wait is not None and self.degradation_rung >= 1:
            max_wait *= self._ladder.config.max_wait_factor
        if (max_wait is not None
                and not self._sched.has_full(self.max_batch)
                and now - self._sched.oldest_arrival() < max_wait):
            return expired
        batch, _, more = self._drain_batch()
        self._serve_batch(batch)
        return batch + expired + more

    def run(self, requests: Sequence[PointCloudRequest]
            ) -> List[PointCloudRequest]:
        """Serve everything queued. ``pack_ahead=True`` uses the pipelined
        loop (class doc): pack batch t+1 on a worker thread while batch t
        executes, with bitwise-identical answers to the serial loop. Both
        loops uphold the degraded-mode contract (module doc): every
        admitted request reaches a terminal outcome, and a faulty batch is
        isolated — not lost, not raised through — in either mode."""
        for r in requests:
            self.submit(r)
        if not self.pack_ahead:
            while self._sched:
                self.step()
            return list(requests)
        pool = ThreadPoolExecutor(max_workers=1)   # single packing worker
        try:
            batch, _, _ = self._drain_batch()
            st = self._try_pack(batch) if batch else None
            while batch:
                nxt, _, _ = self._drain_batch()
                fut = pool.submit(self._try_pack, nxt) if nxt else None
                if isinstance(st, SparseTensor):
                    # guarded dispatch: a session fault in batch t retries /
                    # bisects in place — batch t is answered or error-marked,
                    # never lost, and the prefetched batch t+1 proceeds.
                    self._dispatch(batch, st)
                else:
                    # the overlapped pack failed (st is the exception):
                    # re-pack serially through the full isolation path.
                    self._serve_batch(batch)
                if fut is not None and fut.done():
                    # the pack finished while the device executed — it was
                    # fully hidden (an unfinished pack would still block in
                    # fut.result() below, i.e. not overlapped)
                    self.packs_overlapped += 1
                batch = nxt
                st = fut.result() if fut is not None else None
        finally:
            pool.shutdown(wait=True)
        return list(requests)

    def _try_pack(self, batch: List[PointCloudRequest]):
        """Pack for the overlapped worker: returns the SparseTensor or the
        exception (the worker must never raise into ``fut.result()`` —
        the main thread routes failures through ``_serve_batch``)."""
        try:
            return self._pack(batch)
        except Exception as e:
            return e


# ---------------------------------------------------------------------------
# LM serving: slot-based continuous batching
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # [S] int32
    max_new: int = 32
    temperature: float = 0.0
    out: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False


class ServeEngine:
    """Slot engine over ``params`` (on their device). ``backend`` is the
    attention backend of the prefills (``kernels.ops.resolve_backend``)."""

    def __init__(self, cfg: ModelConfig, params: dict, batch_slots: int = 8,
                 cache_len: int = 512, seed: int = 0, *,
                 backend: str = "auto"):
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.cache_len = cache_len
        self.backend = backend
        self.device = params["embed"].device
        self.state = tf.init_decode_state(cfg, batch_slots, cache_len,
                                          device=self.device)
        self.pos = np.zeros(batch_slots, np.int32)    # per-slot token count
        self.free = list(range(batch_slots))
        self.active: dict[int, Request] = {}
        self.generator = torch.Generator().manual_seed(seed)

    # -- slot management ------------------------------------------------

    def _merge_state(self, slot: int, one_state: dict) -> None:
        """Write a single-request prefill state into batch slot ``slot``."""
        for sk, blocks in self.state.items():
            for bk, leaves in blocks.items():
                for name, leaf in leaves.items():
                    leaf[:, slot] = one_state[sk][bk][name][:, 0]

    def submit(self, req: Request) -> bool:
        if not self.free:
            return False
        slot = self.free.pop()
        req.slot = slot
        tokens = torch.as_tensor(np.asarray(req.prompt)[None])
        logits, st = tf.prefill(self.params, self.cfg, {"tokens": tokens},
                                self.cache_len, backend=self.backend)
        self._merge_state(slot, st)
        self.pos[slot] = len(req.prompt)
        req.out.append(self._sample(logits[0, -1], req))
        self.active[slot] = req
        return True

    def _sample(self, logits: torch.Tensor, req: Request) -> int:
        if req.temperature <= 0:
            return int(logits.argmax())
        probs = torch.softmax(logits.float().cpu() / req.temperature, -1)
        return int(torch.multinomial(probs, 1, generator=self.generator))

    # -- decode ------------------------------------------------------------

    def step(self) -> None:
        """One decode step for all slots (the free ones padded)."""
        if not self.active:
            return
        toks = np.zeros((self.B, 1), np.int32)
        for slot, req in self.active.items():
            toks[slot, 0] = req.out[-1]
        # per-slot positions (continuous batching: slots at different depths)
        logits, self.state = tf.decode_step(
            self.params, self.cfg, self.state, {"tokens": torch.as_tensor(toks)},
            torch.as_tensor(self.pos.copy()))
        lg = logits[:, 0]
        greedy = lg.argmax(-1).tolist()
        for slot, req in list(self.active.items()):
            tok = (greedy[slot] if req.temperature <= 0
                   else self._sample(lg[slot], req))
            req.out.append(tok)
            self.pos[slot] += 1
            if len(req.out) >= req.max_new:
                req.done = True
                del self.active[slot]
                self.free.append(slot)

    def run(self, requests: List[Request]) -> List[Request]:
        pending = list(requests)
        while pending or self.active:
            while pending and self.free:
                self.submit(pending.pop(0))
            self.step()
        return requests
