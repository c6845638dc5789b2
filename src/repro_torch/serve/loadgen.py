"""Deterministic open-loop load generator for the serving engine (torch
port of ``repro.serve.loadgen``).

Overload behavior is only trustworthy if the overload is *replayable*:
the same arrival schedule, the same fault mix, the same clock, the same
outcome mix — every run, on every machine. This module builds exactly
that on top of :class:`~repro_torch.serve.faults.FakeClock`:

* :func:`arrival_times` — an open-loop (arrivals don't wait for
  completions — the defining property of overload: offered load is
  independent of service rate) schedule at a fixed rate.
* :func:`make_traffic` — requests cycled from a pool of scenes, with
  scripted fault mixes (poisoned features, invalid coordinates, per-index
  deadlines) at exact positions.
* :func:`run_open_loop` — the simulation loop: delivers arrivals when
  the fake clock reaches them, steps the engine, and advances time only
  when nothing else can make progress. Service time comes from the
  session itself — wrap it in ``FaultySession(delay=…, sleep=ck.sleep)``
  and each dispatch advances the clock by the service time, which is what
  makes "2× overload" a statement about arithmetic (arrival rate vs
  ``num_scenes / delay``) rather than machine speed.
* :class:`LoadReport` — the scenario's verdict: outcome mix, goodput,
  p99s, shed rate, max queue depth, max degradation rung.

Used by tests/test_torch_serve_overload.py, chip_smoke.py's overload
phase and examples/torch_overload_serve.py.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .engine import PointCloudRequest
from .faults import poison_coords, poison_features


def arrival_times(n: int, rate: float, start: float = 0.0) -> List[float]:
    """``n`` evenly spaced arrivals at ``rate`` requests/second."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    return [start + i / rate for i in range(n)]


def make_traffic(clouds: Sequence[Tuple[np.ndarray, np.ndarray]], n: int, *,
                 layout=None,
                 poison: Sequence[int] = (),
                 invalid: Sequence[int] = (),
                 deadlines: Optional[Dict[int, float]] = None,
                 ) -> List[PointCloudRequest]:
    """``n`` requests cycling through ``clouds``, with scripted faults.

    ``poison`` indices get :func:`poison_features` markers (slip past
    validation, trip a ``feature_poison()`` FaultySession predicate);
    ``invalid`` indices get :func:`poison_coords` (rejected at ingest —
    requires ``layout``); ``deadlines`` maps request index → absolute
    engine-clock deadline. Every request copies its features so faults
    never alias across requests.
    """
    poison, invalid = set(poison), set(invalid)
    if invalid and layout is None:
        raise ValueError("invalid= indices require layout=")
    reqs = []
    for i in range(n):
        coords, feats = clouds[i % len(clouds)]
        coords, feats = np.array(coords, copy=True), np.array(feats, copy=True)
        if i in invalid:
            coords = poison_coords(coords, layout)
        if i in poison:
            feats = poison_features(feats)
        req = PointCloudRequest(coords, feats)
        if deadlines and i in deadlines:
            req.deadline = deadlines[i]
        reqs.append(req)
    return reqs


@dataclasses.dataclass
class LoadReport:
    """One scenario's verdict (module doc)."""

    submitted: int                     # requests offered to submit()
    outcomes: Dict[str, int]           # terminal outcome -> count
    duration: float                    # fake-clock seconds start -> drain
    goodput: float                     # "ok" answers per second
    p99_latency_ok: float              # submit -> ok latency (bucket edge)
    p99_queue_wait: float              # submit -> drain wait (bucket edge)
    shed_rate: float                   # (shed + rejected_open) / submitted
    max_queue_depth: int               # peak engine queue length observed
    max_rung: int                      # deepest degradation rung reached
    counters: Dict[str, int]           # engine counters at scenario end

    def summary(self) -> str:
        mix = " ".join(f"{k}:{v}" for k, v in sorted(self.outcomes.items()))
        return (f"{self.submitted} reqs in {self.duration:.2f}s -> {mix} | "
                f"goodput={self.goodput:.1f}/s p99_ok={self.p99_latency_ok:.3f}s "
                f"shed={self.shed_rate:.0%} depth<={self.max_queue_depth} "
                f"rung<={self.max_rung}")


def run_open_loop(engine, schedule: Sequence[Tuple[float, PointCloudRequest]],
                  clock, *, max_wait: Optional[float] = None,
                  idle_tick: float = 0.01) -> LoadReport:
    """Drive ``engine`` through an open-loop scenario on FakeClock ``clock``.

    ``schedule`` is ``[(arrival_time, request), ...]`` (any order; sorted
    here). The loop delivers every arrival whose time has come, lets the
    engine step, and advances the clock only when neither produced
    progress: to the next arrival if the queue is empty, else by
    ``idle_tick`` (the granularity of ``max_wait`` holds and breaker
    cooldowns). Terminates when every request is finalized — the
    degraded-mode contract guarantees that is reachable — with a
    backstop assert against silent non-termination.
    """
    events = sorted(schedule, key=lambda e: e[0])
    reqs = [r for _t, r in events]
    start = clock()
    i = 0
    max_depth = 0
    max_rung = 0
    stuck = 0
    while True:
        while i < len(events) and events[i][0] <= clock():
            engine.submit(events[i][1])
            i += 1
        max_depth = max(max_depth, len(engine.pending))
        max_rung = max(max_rung, getattr(engine, "degradation_rung", 0))
        before_t = clock()
        finalized = engine.step(max_wait)
        if finalized or clock() != before_t:
            stuck = 0
            continue
        if engine.pending:
            clock.advance(idle_tick)    # waiting out a hold / cooldown
        elif i < len(events):
            clock.advance(max(events[i][0] - clock(), idle_tick))
        elif all(r.finished for r in reqs):
            break
        else:
            clock.advance(idle_tick)    # e.g. breaker open, queue empty
        stuck += 1
        assert stuck < 100_000, "loadgen made no progress for 100k ticks"
    duration = clock() - start
    outcomes: Dict[str, int] = {}
    for r in reqs:
        outcomes[r.outcome] = outcomes.get(r.outcome, 0) + 1
    ok = outcomes.get("ok", 0)
    shed = (outcomes.get("shed", 0) + outcomes.get("rejected_open", 0))
    reg = engine.metrics
    return LoadReport(
        submitted=len(reqs),
        outcomes=outcomes,
        duration=duration,
        goodput=ok / duration if duration > 0 else float(ok),
        p99_latency_ok=(reg.histogram("serve_latency_ok").percentile(0.99)
                        if ok else 0.0),
        p99_queue_wait=reg.histogram("serve_queue_wait").percentile(0.99),
        shed_rate=shed / len(reqs) if reqs else 0.0,
        max_queue_depth=max_depth,
        max_rung=max_rung,
        counters=dict(engine.counters))
