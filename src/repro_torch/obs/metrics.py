"""Metrics registry: counters, gauges, rolling rates and log2 histograms.

One :class:`MetricsRegistry` is the process-wide observability surface for
a plan→serve→train pipeline: `SpiraSession` creates one per session (or
accepts a shared one), and `PointCloudServeEngine` /
`GuardedPointCloudTrainer` / `CheckpointManager` inherit it, so every
latency histogram, degraded-mode counter and per-layer plan gauge lands in
one place and exports through one :meth:`~MetricsRegistry.snapshot` (JSON
dict) or :meth:`~MetricsRegistry.to_prometheus_text` (Prometheus text
format) call.

Design constraints, in order:

* **Little cost on the hot path.** Recording is a few dict/float ops
  under one lock, about a microsecond on a host core — never a device
  sync, never a trace — so the hot path records a handful of metrics per
  call, not one per layer. Instrumentation must not change what the
  pipeline computes: results stay bitwise identical, the graph keys
  (``compile_count``) and the zdelta search-call counters unchanged
  (pinned in tests/test_torch_obs.py and
  tests/test_torch_serve_engine.py). The companion rule that spans live
  OUTSIDE CUDA graphs and kernel wrappers is stated in ``obs.trace``.
* **Deterministic under an injectable clock.** The registry's ``clock``
  (default ``time.perf_counter``) is the single time source for spans and
  rates; tests drive it with ``serve.faults.FakeClock`` and pin exact
  snapshots — counts, bucket occupancy, percentiles (tests/test_obs.py).
* **Thread-safe.** The pack-ahead serving worker and the async checkpoint
  writer record from their own threads; every mutation takes the registry
  lock.
* **Dependency-free.** Stdlib only — importable before (and without)
  torch.

Histograms are fixed-edge log2 buckets: edges ``2**lo .. 2**hi`` seconds
(defaults span ~1 µs to 64 s), one overflow bucket above. ``record(v)``
files ``v`` into the first bucket with ``v <= edge`` (values at an edge
belong to that edge's bucket; values below the first edge land in bucket
0). Percentiles are conservative upper-bucket-edge estimates: ``pXX`` is
the upper edge of the bucket holding the ``ceil(q·count)``-th sample
(``+inf`` for the overflow bucket, ``0.0`` when empty) — exact enough for
latency SLO work, exactly reproducible for tests.
"""
from __future__ import annotations

import math
import re
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple


class Counter:
    """Monotonic event count. ``set(v)`` exists for the registry-backed
    attribute views (an engine's ``__init__`` zeroes its counters) — not
    for general use."""

    kind = "counter"

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def set(self, v: int) -> None:
        with self._lock:
            self._value = int(v)

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-written value (bucket size, escalation level, per-layer plan
    stat). Not cumulative; ``set`` replaces."""

    kind = "gauge"

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class RateMeter:
    """Rolling events-per-second over a trailing ``window`` (the serving
    QPS gauge). ``mark(n)`` stamps n events at the registry clock's now;
    ``rate()`` is (events within the last ``window`` seconds) / ``window``
    — deterministic under FakeClock, cheap (a deque prune) under a real
    one."""

    kind = "rate"

    def __init__(self, name: str, lock: threading.Lock,
                 clock: Callable[[], float], window: float = 60.0):
        self.name = name
        self.window = float(window)
        self._lock = lock
        self._clock = clock
        self._events: deque = deque()   # (t, n)
        self.total = 0                  # lifetime marks (never pruned)

    def _prune(self, now: float) -> None:
        horizon = now - self.window
        while self._events and self._events[0][0] <= horizon:
            self._events.popleft()

    def mark(self, n: int = 1) -> None:
        with self._lock:
            now = self._clock()
            self._events.append((now, n))
            self.total += n
            self._prune(now)

    def rate(self) -> float:
        with self._lock:
            self._prune(self._clock())
            return sum(n for _, n in self._events) / self.window


# default histogram span: 2^-20 s (~0.95 µs) .. 2^6 s (64 s)
HIST_LO = -20
HIST_HI = 6


class Histogram:
    """Fixed-edge log2-bucket histogram (module doc): per-bucket
    occupancy + count/sum, percentiles as upper-bucket-edge estimates."""

    kind = "histogram"

    def __init__(self, name: str, lock: threading.Lock,
                 lo: int = HIST_LO, hi: int = HIST_HI):
        if hi <= lo:
            raise ValueError(f"histogram {name!r}: hi ({hi}) must be > lo "
                             f"({lo})")
        self.name = name
        self._lock = lock
        self.edges: Tuple[float, ...] = tuple(2.0 ** e
                                              for e in range(lo, hi + 1))
        self.counts: List[int] = [0] * (len(self.edges) + 1)  # +overflow
        self.count = 0
        self.sum = 0.0

    def record(self, v: float) -> None:
        v = float(v)
        idx = bisect_left(self.edges, v)    # first edge >= v ⇒ v <= edge
        with self._lock:
            self.counts[idx] += 1
            self.count += 1
            self.sum += v

    def percentile(self, q: float) -> float:
        """Upper edge of the bucket holding the ceil(q·count)-th sample;
        0.0 when empty, +inf when that sample overflowed the last edge."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"q must be in (0, 1], got {q}")
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = math.ceil(q * self.count)
            cum = 0
            for i, c in enumerate(self.counts):
                cum += c
                if cum >= rank:
                    return (self.edges[i] if i < len(self.edges)
                            else float("inf"))
        return float("inf")     # unreachable; counts always sum to count

    def occupancy(self) -> Dict[str, int]:
        """Non-empty buckets keyed by upper edge (``"+Inf"`` for the
        overflow bucket) — the compact snapshot form."""
        with self._lock:
            out = {}
            for i, c in enumerate(self.counts):
                if c:
                    key = (_edge_str(self.edges[i]) if i < len(self.edges)
                           else "+Inf")
                    out[key] = c
            return out


def _edge_str(e: float) -> str:
    return repr(e)


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Sanitize a metric name to the Prometheus grammar
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``): every illegal char becomes ``_``."""
    n = _NAME_RE.sub("_", name)
    if not n or n[0].isdigit():
        n = "_" + n
    return n


class MetricsRegistry:
    """Named metrics with get-or-create accessors (module doc).

    ``clock`` is the registry's single time source — ``obs.trace.span``
    and :class:`RateMeter` read it, so handing a
    ``serve.faults.FakeClock`` here makes every duration and rate exactly
    deterministic. All accessors are thread-safe; re-requesting a name
    returns the same metric object, and requesting an existing name as a
    different kind raises."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, self._lock, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested as {cls.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, lo: int = HIST_LO,
                  hi: int = HIST_HI) -> Histogram:
        return self._get(name, Histogram, lo=lo, hi=hi)

    def rate(self, name: str, window: float = 60.0) -> RateMeter:
        return self._get(name, RateMeter, clock=self.clock, window=window)

    # -- exporters --------------------------------------------------------

    def snapshot(self) -> dict:
        """One JSON-native dict of everything: counters/gauges/rates by
        name, histograms as ``{count, sum, p50, p90, p99, buckets}`` with
        only non-empty buckets listed. Round-trips through ``json.dumps``
        / ``json.loads`` unchanged (pinned in tests/test_obs.py; the CI
        obs stage asserts it on live runs)."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict = {"counters": {}, "gauges": {}, "rates": {},
                     "histograms": {}}
        for m in metrics:
            if isinstance(m, Counter):
                out["counters"][m.name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][m.name] = m.value
            elif isinstance(m, RateMeter):
                out["rates"][m.name] = m.rate()
            elif isinstance(m, Histogram):
                out["histograms"][m.name] = {
                    "count": m.count,
                    "sum": m.sum,
                    "p50": m.percentile(0.50),
                    "p90": m.percentile(0.90),
                    "p99": m.percentile(0.99),
                    "buckets": m.occupancy(),
                }
        return out

    def to_prometheus_text(self, prefix: str = "spira_") -> str:
        """Prometheus text exposition format. Histograms emit the full
        cumulative ``_bucket{le=...}`` series + ``_sum`` / ``_count``;
        rates export as gauges. Names are sanitized to the Prometheus
        grammar; :func:`parse_prometheus_text` validates the output."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines: List[str] = []
        for name, m in metrics:
            pn = _prom_name(prefix + name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pn} counter")
                lines.append(f"{pn} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pn} gauge")
                lines.append(f"{pn} {m.value}")
            elif isinstance(m, RateMeter):
                lines.append(f"# TYPE {pn} gauge")
                lines.append(f"{pn} {m.rate()}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {pn} histogram")
                cum = 0
                for i, edge in enumerate(m.edges):
                    cum += m.counts[i]
                    lines.append(
                        f'{pn}_bucket{{le="{_edge_str(edge)}"}} {cum}')
                cum += m.counts[-1]
                lines.append(f'{pn}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{pn}_sum {m.sum}")
                lines.append(f"{pn}_count {m.count}")
        return "\n".join(lines) + "\n"


# one line of Prometheus text exposition: either a TYPE/HELP comment or a
# `name{labels} value` sample
_PROM_COMMENT_RE = re.compile(
    r"^# (TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
    r"(counter|gauge|histogram|summary|untyped)|HELP .*)$")
_PROM_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^{}]*)\})?"
    r" (?P<value>[^ ]+)$")
_PROM_LABEL_RE = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"$')


def parse_prometheus_text(text: str) -> Dict[str, List[Tuple[str, float]]]:
    """Validate Prometheus text-format line grammar and return samples as
    ``{metric_name: [(labels, value), ...]}``. Raises :class:`ValueError`
    naming the first malformed line — the CI obs stage's export check."""
    samples: Dict[str, List[Tuple[str, float]]] = {}
    for ln, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("#"):
            if not _PROM_COMMENT_RE.match(line):
                raise ValueError(f"line {ln}: malformed comment: {line!r}")
            continue
        m = _PROM_SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {ln}: malformed sample: {line!r}")
        labels = m.group("labels") or ""
        if labels:
            for part in labels.split(","):
                if not _PROM_LABEL_RE.match(part.strip()):
                    raise ValueError(
                        f"line {ln}: malformed label {part!r} in {line!r}")
        try:
            value = float(m.group("value"))
        except ValueError:
            raise ValueError(
                f"line {ln}: non-numeric value {m.group('value')!r}"
            ) from None
        samples.setdefault(m.group("name"), []).append((labels, value))
    return samples


# ---------------------------------------------------------------------------
# the process-global default registry + registry-backed attribute views
# ---------------------------------------------------------------------------

_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry — the home of module-level trace
    counters (``core.zdelta``'s search calls); a standalone
    :func:`obs.trace.span` records here when handed it. Pipeline components
    (session/engine/trainer/ckpt) prefer a per-session registry so tests
    stay isolated; pass ``metrics=default_registry()`` to merge a pipeline
    into the global surface."""
    return _DEFAULT


class CounterView:
    """Descriptor exposing a registry counter as a plain int attribute.

    The pre-obs engine/trainer counters were instance ints mutated with
    ``self.x += 1`` and read by tests as ``engine.x``; this view keeps
    that exact surface while sourcing the value from ``obj.metrics``
    (which must exist before the first assignment), so the ``counters``
    dict and the registry can never disagree."""

    def __init__(self, metric: str):
        self.metric = metric

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.metrics.counter(self.metric).value

    def __set__(self, obj, value) -> None:
        obj.metrics.counter(self.metric).set(value)
