"""Unified observability: metrics registry, histograms, spans, exporters.

One `MetricsRegistry` per pipeline (session → engine/trainer → ckpt all
share it); `span(...)` context managers time host-side phases into
registry histograms at the host boundary (see obs.trace);
`snapshot()` / `to_prometheus_text()` export everything. Stdlib-only.
"""
from .metrics import (
    Counter,
    CounterView,
    Gauge,
    Histogram,
    MetricsRegistry,
    RateMeter,
    default_registry,
    parse_prometheus_text,
)
from .trace import current_path, span

__all__ = [
    "Counter",
    "CounterView",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "RateMeter",
    "default_registry",
    "parse_prometheus_text",
    "current_path",
    "span",
]
