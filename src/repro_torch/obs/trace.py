"""Nestable wall-time spans recording into a MetricsRegistry.

``span("serve/pack", reg)`` times its body on the registry clock and
records the elapsed seconds into ``reg.histogram(path)``, where *path* is
the "/"-joined chain of enclosing spans on this thread — so a
``span("dispatch")`` inside ``span("serve")`` lands in the
``serve/dispatch`` histogram. A span name may itself be a multi-segment
fragment (``span("serve/pack")`` at top level records ``serve/pack``
directly — the instrumented components use this flat namespacing). The
stack is thread-local: the pack-ahead serving worker and the async
checkpoint writer nest independently of the main thread.

Spans live at the host boundary (around a session call, never inside a
kernel wrapper), and nothing they measure feeds back into the
computation, so results are bitwise the same with or without them.

Spans measure host wall-time, which under CUDA's asynchronous launches is
enqueue time unless the body synchronizes (the session's call span covers
the drop-count materialization, which does). For on-device attribution,
``annotate=True`` additionally wraps the body in
``torch.profiler.record_function`` so the span name shows up on the
profiler timeline; this is off by default and imported lazily so obs stays
dependency-free.
"""
from __future__ import annotations

import threading
from typing import Optional

from .metrics import MetricsRegistry, default_registry

_local = threading.local()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def current_path() -> str:
    """The "/"-joined path of spans currently open on this thread
    (empty string at top level)."""
    return "/".join(_stack())


class span:
    """Context manager timing its body into ``registry.histogram(path)``.

    The elapsed time is recorded even when the body raises (the exception
    still propagates) — a failed dispatch is exactly the latency you want
    on the histogram. Re-entrant per thread via the thread-local stack;
    a span object itself is single-use.
    """

    def __init__(self, name: str, registry: Optional[MetricsRegistry] = None,
                 *, annotate: bool = False):
        if not name or name.startswith("/") or name.endswith("/"):
            raise ValueError(
                f"span name must be a non-empty path fragment, got {name!r}")
        self.name = name
        self.registry = registry if registry is not None else default_registry()
        self.annotate = annotate
        self.path = ""
        self._t0 = 0.0
        self._ann = None

    def __enter__(self) -> "span":
        st = _stack()
        st.append(self.name)
        self.path = "/".join(st)
        if self.annotate:
            import torch
            self._ann = torch.profiler.record_function(self.path)
            self._ann.__enter__()
        self._t0 = self.registry.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        elapsed = self.registry.clock() - self._t0
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
            self._ann = None
        _stack().pop()
        self.registry.histogram(self.path).record(elapsed)
        return False
