"""Overload-control policies for the point-cloud serving engine (torch
port of ``repro.serve.scheduler``, the arithmetic unchanged).

The engine's fault story (quarantine / retry / shed / deadlines) said
what happens to one bad request; this module says what happens when the
*traffic* is bad. Four policies, each a small deterministic state machine
on the engine's injectable clock, each independently testable:

* **Schedulers** — the queue discipline behind
  :meth:`PointCloudServeEngine.submit`. :class:`FifoScheduler` preserves
  the legacy single-queue arrival order; :class:`BucketScheduler` keeps one
  queue per pow2 capacity bucket (``serve.bucketing.bucket_capacity`` —
  the session's compile key) so every dispatched batch is
  bucket-homogeneous: scenes of similar size pack together, a giant scene
  never drags a batch of small ones up to its padded capacity, and each
  bucket's batch is dispatched independently (the ROADMAP's multi-bucket
  in-flight batching). Within a bucket the drain order is
  earliest-deadline-first (deadline-less requests rank last, FIFO among
  themselves), and :meth:`expire` excises already-doomed requests from
  every queue before any device work is spent on them.

* **:class:`AdmissionController`** — CoDel-style adaptive admission.
  The blunt ``max_queue`` cliff sheds on queue *length*, which is the
  wrong signal (a long queue of tiny scenes may be fine; a short queue
  behind a slow session is not). CoDel's insight: control on queue
  *delay*. The engine feeds every observed ``serve_queue_wait`` sample to
  :meth:`observe`; once the standing delay has exceeded ``target`` for a
  full ``interval``, :meth:`offer` starts shedding — first one request,
  then at increasing rate (the canonical ``interval / sqrt(drop_count)``
  control law) until a sample comes in under target or the queue drains
  idle. Deterministic given a deterministic clock — no randomness.

* **:class:`CircuitBreaker`** — fail-fast around session dispatch.
  ``closed`` (normal) → ``open`` after ``threshold`` consecutive
  non-transient dispatch failures (requests are finalized
  ``rejected_open`` instantly, no pack, no device work, no retry burn) →
  ``half_open`` after ``cooldown`` (exactly one probe batch is let
  through) → ``closed`` on probe success, back to ``open`` on failure.

* **:class:`DegradationLadder`** — graceful degradation under sustained
  pressure. Same delay signal as admission, but instead of shedding it
  trades answer quality/latency headroom for survival, one rung at a
  time: tighten ``max_wait`` (rung 1) → disable replan escalation, serving
  with ``HealthReport`` drops flagged (rung 2) → voxel-budget downsampling
  of oversized scenes at pack time (rung 3). Rungs step back down
  deterministically after the delay has stayed under target for
  ``deescalate_after``. Every transition is counted and gauged; every
  served request carries the rung it was packed under
  (``PointCloudRequest.degradation``).

Nothing in this module touches the device or imports torch: policies decide,
the engine acts. All time arithmetic uses the clock *values the engine
passes in* — with :class:`~repro_torch.serve.faults.FakeClock` every
scenario in ``serve.loadgen`` replays bit-exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from .bucketing import bucket_capacity


class DispatchTimeoutError(RuntimeError):
    """A session dispatch exceeded the engine's ``dispatch_timeout``: the
    watchdog gave up waiting. Non-transient by construction — retrying a
    hung call burns another timeout — so the engine finalizes the batch
    ``dispatch_timeout`` and feeds the circuit breaker instead."""


# ---------------------------------------------------------------------------
# queue disciplines
# ---------------------------------------------------------------------------

def _edf_key(entry: Tuple[int, float, object]) -> Tuple[float, int]:
    """Earliest-deadline-first order: by deadline, then by submission
    sequence (FIFO among equal/absent deadlines)."""
    seq, _at, req = entry
    deadline = req.deadline if req.deadline is not None else math.inf
    return (deadline, seq)


class FifoScheduler:
    """Single arrival-ordered queue — the legacy engine discipline.

    Kept as the default so existing callers (and the pack-ahead pipelined
    loop's ordering assumptions) see byte-identical behavior; the overload
    features (expiry excision, admission, breaker, ladder) all work on top
    of it too.
    """

    def __init__(self) -> None:
        self._q: List[Tuple[int, float, object]] = []   # (seq, arrival, req)
        self._seq = 0

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def push(self, req, at: float) -> None:
        self._q.append((self._seq, at, req))
        self._seq += 1

    def oldest_arrival(self) -> Optional[float]:
        """Arrival time of the request that has waited longest (the
        ``max_wait`` hold signal), or None when empty."""
        return self._q[0][1] if self._q else None

    def has_full(self, max_batch: int) -> bool:
        """Whether a drain can fill a whole batch right now."""
        return len(self._q) >= max_batch

    def expire(self, now: float) -> List[Tuple[object, float]]:
        """Excise every queued request whose deadline has passed; returns
        ``[(req, arrival), ...]`` for the engine to finalize."""
        dead = [(r, at) for _s, at, r in self._q
                if r.deadline is not None and now > r.deadline]
        if dead:
            self._q = [(s, at, r) for s, at, r in self._q
                       if not (r.deadline is not None and now > r.deadline)]
        return dead

    def drain(self, now: float, max_batch: int
              ) -> Tuple[List[object], List[float]]:
        """Pop up to ``max_batch`` requests in arrival order."""
        take, self._q = self._q[:max_batch], self._q[max_batch:]
        return [r for _s, _at, r in take], [at for _s, at, _r in take]

    def depths(self) -> Dict[int, int]:
        return {0: len(self._q)} if self._q else {}


class BucketScheduler:
    """Per-pow2-capacity-bucket queues with EDF drain order (module doc).

    ``min_bucket`` must match the session's (the compile key), so a
    drained batch pads to exactly its bucket's capacity. :meth:`drain`
    serves ONE bucket per call — full buckets first (maximum batching
    efficiency), otherwise the bucket holding the most urgent request —
    so under mixed traffic every bucket makes progress and no bucket's
    half-full batch waits on another bucket's arrivals.
    """

    def __init__(self, min_bucket: int = 1024,
                 max_bucket: Optional[int] = None) -> None:
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self._q: Dict[int, List[Tuple[int, float, object]]] = {}
        self._seq = 0

    def _key(self, req) -> int:
        return bucket_capacity(max(len(req.coords), 1),
                               min_bucket=self.min_bucket,
                               max_bucket=self.max_bucket)

    def __len__(self) -> int:
        return sum(len(q) for q in self._q.values())

    def __bool__(self) -> bool:
        return any(self._q.values())

    def push(self, req, at: float) -> None:
        self._q.setdefault(self._key(req), []).append((self._seq, at, req))
        self._seq += 1

    def oldest_arrival(self) -> Optional[float]:
        arrivals = [at for q in self._q.values() for _s, at, _r in q]
        return min(arrivals) if arrivals else None

    def has_full(self, max_batch: int) -> bool:
        return any(len(q) >= max_batch for q in self._q.values())

    def expire(self, now: float) -> List[Tuple[object, float]]:
        dead: List[Tuple[object, float]] = []
        for cap in list(self._q):
            q = self._q[cap]
            live = [(s, at, r) for s, at, r in q
                    if not (r.deadline is not None and now > r.deadline)]
            if len(live) != len(q):
                dead.extend((r, at) for s, at, r in q
                            if r.deadline is not None and now > r.deadline)
                if live:
                    self._q[cap] = live
                else:
                    del self._q[cap]
        return dead

    def _select(self, max_batch: int) -> Optional[int]:
        """The bucket to drain: a full one if any (smallest capacity wins
        ties — cheapest dispatch), else the one with the most urgent EDF
        head."""
        full = sorted(cap for cap, q in self._q.items()
                      if len(q) >= max_batch)
        if full:
            return full[0]
        best, best_key = None, None
        for cap in sorted(self._q):
            q = self._q[cap]
            if not q:
                continue
            head = min(_edf_key(e) for e in q)
            if best_key is None or head < best_key:
                best, best_key = cap, head
        return best

    def drain(self, now: float, max_batch: int
              ) -> Tuple[List[object], List[float]]:
        """Pop up to ``max_batch`` requests from ONE bucket, EDF order."""
        cap = self._select(max_batch)
        if cap is None:
            return [], []
        q = sorted(self._q[cap], key=_edf_key)
        take, rest = q[:max_batch], q[max_batch:]
        if rest:
            self._q[cap] = rest
        else:
            del self._q[cap]
        return [r for _s, _at, r in take], [at for _s, at, _r in take]

    def depths(self) -> Dict[int, int]:
        """Queue depth per capacity bucket (obs gauge surface)."""
        return {cap: len(q) for cap, q in sorted(self._q.items()) if q}


# ---------------------------------------------------------------------------
# adaptive admission (CoDel on queue delay)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """CoDel knobs: shed once observed queue wait has exceeded ``target``
    (seconds) continuously for ``interval`` (seconds)."""

    target: float = 0.05
    interval: float = 1.0


class AdmissionController:
    """Queue-delay admission control (module doc). The engine calls
    :meth:`observe` with every queue-wait sample it records and
    :meth:`offer` for every submit; ``offer`` returning False means shed."""

    def __init__(self, config: AdmissionConfig = AdmissionConfig()) -> None:
        self.config = config
        self._first_above: Optional[float] = None   # when wait went above
        self._shedding = False
        self._next_shed = 0.0
        self._drop_count = 0
        self.sheds = 0                               # lifetime sheds

    def observe(self, wait: float, now: float) -> None:
        """Feed one queue-wait sample (seconds) observed at ``now``."""
        if wait < self.config.target:
            # standing delay is under control: leave shedding mode
            self._first_above = None
            self._shedding = False
            self._drop_count = 0
        elif self._first_above is None:
            self._first_above = now

    def offer(self, now: float, queue_len: int) -> bool:
        """Admission decision for a submit at ``now``. True = admit."""
        if queue_len == 0:
            # an empty queue cannot have standing delay — reset
            self._first_above = None
            self._shedding = False
            self._drop_count = 0
            return True
        if (self._first_above is not None and not self._shedding
                and now - self._first_above >= self.config.interval):
            # delay has stood above target for a full interval: start
            self._shedding = True
            self._drop_count = 0
            self._next_shed = now
        if self._shedding and now >= self._next_shed:
            self._drop_count += 1
            self.sheds += 1
            # CoDel control law: shed at increasing rate while above target
            self._next_shed = now + (self.config.interval
                                     / math.sqrt(self._drop_count + 1))
            return False
        return True


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """``threshold`` consecutive non-transient dispatch failures open the
    breaker; after ``cooldown`` seconds one half-open probe is allowed."""

    threshold: int = 3
    cooldown: float = 1.0


class CircuitBreaker:
    """closed → open → half_open → closed dispatch gate (module doc)."""

    def __init__(self, config: BreakerConfig = BreakerConfig()) -> None:
        self.config = config
        self.state = "closed"
        self.failures = 0          # consecutive failures while closed
        self.trips = 0             # lifetime closed→open transitions
        self._opened_at = 0.0

    def allow(self, now: float) -> bool:
        """Whether a dispatch may proceed at ``now``. While open, flips to
        half_open once ``cooldown`` has elapsed and admits that single
        probe; further calls stay rejected until the probe resolves."""
        if self.state == "closed":
            return True
        if self.state == "open":
            if now - self._opened_at >= self.config.cooldown:
                self.state = "half_open"
                return True
            return False
        return False   # half_open: the probe is already in flight

    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0

    def record_failure(self, now: float) -> bool:
        """Record a non-transient dispatch failure; returns True when this
        failure tripped the breaker (closed/half_open → open)."""
        if self.state == "half_open":
            self.state = "open"
            self._opened_at = now
            self.trips += 1    # the probe failed: a fresh trip
            return True
        self.failures += 1
        if self.state == "closed" and self.failures >= self.config.threshold:
            self.state = "open"
            self._opened_at = now
            self.trips += 1
            return True
        return False


# ---------------------------------------------------------------------------
# graceful-degradation ladder
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LadderConfig:
    """Pressure thresholds and per-rung knobs (module doc).

    * ``target`` — queue-wait (seconds) above which the engine is "under
      pressure"; shared signal with admission but tracked independently.
    * ``escalate_after`` / ``deescalate_after`` — how long the wait must
      stay above/below target before stepping a rung up/down (hysteresis:
      de-escalation is deliberately slower than escalation).
    * ``max_wait_factor`` — rung ≥ 1 scales the caller's ``max_wait`` by
      this factor (tighter batching hold = lower queueing delay).
    * ``voxel_budget`` — rung ≥ 3 downsamples scenes with more input
      points than this to exactly this many at pack time.
    * ``max_rung`` — ceiling (≤ 3); set 2 to never downsample.
    """

    target: float = 0.05
    escalate_after: float = 1.0
    deescalate_after: float = 2.0
    max_wait_factor: float = 0.25
    voxel_budget: int = 4096
    max_rung: int = 3


RUNGS = ("healthy", "tight_max_wait", "no_escalation", "voxel_budget")


class DegradationLadder:
    """Sustained-pressure rung state machine (module doc). The engine
    feeds it the same queue-wait samples as admission; ``rung`` is read at
    drain/pack/dispatch time to apply the active degradations."""

    def __init__(self, config: LadderConfig = LadderConfig()) -> None:
        self.config = config
        self.rung = 0
        self.escalations = 0       # lifetime rung-up transitions
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None

    @property
    def label(self) -> str:
        return RUNGS[self.rung]

    def observe(self, wait: float, now: float) -> int:
        """Feed one queue-wait sample; returns the (possibly new) rung."""
        cfg = self.config
        if wait >= cfg.target:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            elif (now - self._above_since >= cfg.escalate_after
                    and self.rung < min(cfg.max_rung, len(RUNGS) - 1)):
                self.rung += 1
                self.escalations += 1
                self._above_since = now    # restart the timer per rung
        else:
            self._above_since = None
            if self.rung == 0:
                self._below_since = None
            elif self._below_since is None:
                self._below_since = now
            elif now - self._below_since >= cfg.deescalate_after:
                self.rung -= 1
                self._below_since = now    # restart the timer per rung
        return self.rung
