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

A span opened without a registry records into the registry of the span
that encloses it on this thread, so a stage inside ``session/call`` or
``train/step`` lands beside its parent without being handed the registry.
With no enclosing span it records nothing (it still opens its profiler
range): the trainer's step closures, called from a user's own loop, leave
no bare ``forward`` or ``optimizer`` histogram anywhere.

Spans live at the host boundary (around a session call or a training
stage, never inside a kernel wrapper or a CUDA graph), and nothing they
measure feeds back into the computation, so results are bitwise the same
with or without them.

Spans measure host wall-time, which under CUDA's asynchronous launches is
enqueue time unless the body synchronizes (the session's
``session/call/read`` and the trainer's ``train/step/read`` wait for the
device). While a ``torch.profiler`` records, every span also opens a
``torch.profiler.record_function`` range named by its path, so the
program's stages sit on the profiler's timeline, on the device trace's
clock. The check reads ``torch.autograd.profiler._is_profiler_enabled``
through ``sys.modules``: obs imports nothing outside the standard
library, and with no profiler recording a span opens no range (an idle
``record_function`` still costs a dispatcher call).
"""
from __future__ import annotations

import sys
import threading
from typing import Optional

from .metrics import MetricsRegistry

_local = threading.local()
_PROFILER = "torch.autograd.profiler"


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def current_path() -> str:
    """The "/"-joined path of spans currently open on this thread
    (empty string at top level)."""
    st = _stack()
    return st[-1].path if st else ""


def _profiler():
    """``torch.autograd.profiler`` while a profiler records, else None."""
    prof = sys.modules.get(_PROFILER)
    return prof if prof is not None and prof._is_profiler_enabled else None


class span:
    """Context manager timing its body into ``registry.histogram(path)``
    (the enclosing span's registry when none is given; none at top level:
    no record).

    The elapsed time is recorded even when the body raises (the exception
    still propagates) — a failed dispatch is exactly the latency you want
    on the histogram. Re-entrant per thread via the thread-local stack;
    a span object itself is single-use.
    """

    def __init__(self, name: str, registry: Optional[MetricsRegistry] = None):
        if not name or name.startswith("/") or name.endswith("/"):
            raise ValueError(
                f"span name must be a non-empty path fragment, got {name!r}")
        self.name = name
        self.registry = registry
        self.path = ""
        self._t0 = 0.0
        self._range = None

    def __enter__(self) -> "span":
        st = _stack()
        parent = st[-1] if st else None
        if self.registry is None and parent is not None:
            self.registry = parent.registry
        self.path = (f"{parent.path}/{self.name}" if parent is not None
                     else self.name)
        st.append(self)
        prof = _profiler()
        if prof is not None:
            self._range = prof.record_function(self.path)
            self._range.__enter__()
        if self.registry is not None:
            self._t0 = self.registry.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        reg = self.registry
        elapsed = reg.clock() - self._t0 if reg is not None else 0.0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        _stack().pop()
        if reg is not None:
            reg.histogram(self.path).record(elapsed)
        return False
