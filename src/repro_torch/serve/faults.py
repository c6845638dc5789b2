"""Fault-injection harness for the serving stack (torch port of
``repro.serve.faults``; the trainer's injector is ``train.faults``).

Serving robustness claims are only as good as the faults they were exercised
against, so this module makes every failure mode the engine defends against
*injectable and deterministic*:

* **Transient device faults** — :class:`FaultySession` raises
  :class:`TransientError` on a scheduled set of call indices, then recovers;
  exercises the engine's capped-backoff retry.
* **Poisoned requests** — a ``poison`` predicate over the packed input makes
  the session fail *deterministically* for any batch containing the poisoned
  scene; exercises bisection quarantine (the engine must isolate exactly the
  poisoned request and serve the rest bitwise-identically to a clean run).
* **Slow packs / slow calls** — ``delay`` (with an injectable ``sleep``)
  makes session calls take a controlled amount of wall-clock, so
  pack/execute-overlap tests don't depend on machine speed.
* **Frozen time** — :class:`FakeClock` drives the engine's ``clock`` and
  ``sleep`` injection points, so deadline and backoff behavior are tested
  without real sleeping.

Corruption helpers (``poison_coords`` / ``poison_features``) build inputs
that violate — or deliberately *pass* — the ingest contract
(``core.validate``), for testing both the validation boundary and the
faults that slip past it.

Nothing here is imported by the hot path; the engine only imports the
exception types (to classify transient errors by default).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, Optional, Sequence

import numpy as np


class TransientError(RuntimeError):
    """An injected fault that a retry is expected to cure (the stand-in for
    device-side RESOURCE_EXHAUSTED / UNAVAILABLE style failures)."""


class PoisonError(RuntimeError):
    """An injected fault that deterministically follows one request: every
    batch containing the poisoned scene fails. Retries cannot cure it; only
    isolating the request can."""


def poison_coords(coords: np.ndarray, layout, row: int = 0) -> np.ndarray:
    """Corrupt one coordinate row so it *aliases* under ``pack()`` (value
    past the field width) — must be caught by the ingest validator."""
    bad = np.array(coords, copy=True)
    bad[row, 0] = (1 << layout.bx) + 3
    return bad


POISON_MAGNITUDE = 1e12   # large but finite: passes the ingest validator


def poison_features(features: np.ndarray, row: int = 0) -> np.ndarray:
    """Plant a finite-but-absurd feature value: slips past validation (it
    is finite) and is detectable by :func:`feature_poison` at the session
    boundary — the model for faults validation cannot see."""
    bad = np.array(features, copy=True)
    bad[row, 0] = POISON_MAGNITUDE
    return bad


def feature_poison(threshold: float = POISON_MAGNITUDE / 2
                   ) -> Callable[[object], bool]:
    """Poison predicate for :class:`FaultySession`: trips on any packed
    input whose features carry a :func:`poison_features` marker. Reads the
    features where they lie (CPU or card), as torch tensors."""
    def pred(st) -> bool:
        return bool((st.features.abs() >= threshold).any())
    return pred


class FakeClock:
    """Deterministic time source for engine tests: ``clock()`` reads it,
    ``sleep(dt)`` advances it — so backoff and deadline logic run at test
    speed with exact arithmetic."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)
        self.sleeps: list = []    # every dt passed to sleep, in order

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt

    def sleep(self, dt: float) -> None:
        self.sleeps.append(dt)
        self.t += dt


class FaultySession:
    """A :class:`~repro_torch.serve.session.SpiraSession` wrapper that injects
    faults on a schedule. Duck-type compatible with the engine (callable +
    ``layout`` + ``num_scenes`` + ``run_with_health``), so it drops into
    :class:`~repro_torch.serve.engine.PointCloudServeEngine` unchanged.

    * ``fail_calls`` — call indices (0-based, counted across the wrapper's
      lifetime) that raise ``exc`` *instead of* running; later calls
      succeed, modeling a transient device fault.
    * ``poison`` — predicate over the packed :class:`SparseTensor`; when it
      trips, the call raises :class:`PoisonError` every time (deterministic
      request-borne fault — see :func:`feature_poison`).
    * ``delay`` — seconds of ``sleep`` before each call (slow device /
      slow model, for overlap and deadline tests; with a FakeClock's
      ``sleep``, this is the injectable *service time* the load generator
      builds overload arithmetic on).
    * ``hang_calls`` — call indices that block on ``hang_release``
      (a ``threading.Event``) instead of running: a truly wedged dispatch,
      for the engine's watchdog. Tests MUST ``hang_release.set()`` in
      teardown so the abandoned daemon thread finishes.
    """

    def __init__(self, session, *, fail_calls: Iterable[int] = (),
                 exc: type = TransientError,
                 poison: Optional[Callable[[object], bool]] = None,
                 delay: float = 0.0,
                 sleep: Callable[[float], None] = time.sleep,
                 hang_calls: Iterable[int] = ()):
        self.session = session
        # keep lazy containers (range) as-is: `i in range(...)` is O(1)
        self.fail_calls = (fail_calls if hasattr(fail_calls, "__contains__")
                           else frozenset(fail_calls))
        self.exc = exc
        self.poison = poison
        self.delay = delay
        self._sleep = sleep
        self.hang_calls = (hang_calls if hasattr(hang_calls, "__contains__")
                           else frozenset(hang_calls))
        self.hang_release = threading.Event()
        self.calls = 0            # total calls seen (including failed ones)
        self.faults_raised = 0
        self.last_call_kwargs: Optional[dict] = None   # run_with_health kw
                                                       # seen on the last call

    # engine duck-type surface ------------------------------------------------

    @property
    def layout(self):
        return self.session.layout

    @property
    def num_scenes(self):
        return self.session.num_scenes

    @property
    def net(self):
        return self.session.net

    @property
    def device(self):
        # the engine's dispatch watchdog enters the session's CUDA device
        return getattr(self.session, "device", None)

    @property
    def metrics(self):
        # engines built over the wrapper inherit the wrapped session's
        # registry, same as over a bare session
        return getattr(self.session, "metrics", None)

    @property
    def min_bucket(self):
        # the engine's BucketScheduler keys queues off the session's
        # bucketing policy; proxy it like layout/num_scenes
        return getattr(self.session, "min_bucket", 1024)

    @property
    def max_bucket(self):
        return getattr(self.session, "max_bucket", None)

    def _gate(self, st) -> None:
        i = self.calls
        self.calls += 1
        if self.delay:
            self._sleep(self.delay)
        if i in self.hang_calls:
            self.hang_release.wait()   # wedged until the test releases it
        if self.poison is not None and self.poison(st):
            self.faults_raised += 1
            raise PoisonError(
                f"injected poison tripped at call {i} "
                f"(batch of {int(st.num_scenes)} scene slots)")
        if i in self.fail_calls:
            self.faults_raised += 1
            raise self.exc(f"injected transient fault at call {i}")

    def run_with_health(self, st, **kw):
        self.last_call_kwargs = dict(kw)
        self._gate(st)
        if hasattr(self.session, "run_with_health"):
            return self.session.run_with_health(st, **kw)
        return self.session(st), None

    def __call__(self, st):
        return self.run_with_health(st)[0]
