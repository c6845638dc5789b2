"""The traced window: ``torch.profiler`` over the measured loop, read back
as device operations (kernels, copies, sets) and the harness's own host
ranges (``bench/...``), all in the profiler's nanosecond clock."""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import List, Tuple

PREFIX = "bench/"
Span = Tuple[str, int, int]


@dataclasses.dataclass
class Trace:
    ops: List[Span]       # device operations in the window
    ranges: List[Span]    # the harness's host ranges in the window
    lo: int               # the window, from its own host range
    hi: int

    @property
    def seconds(self) -> float:
        return (self.hi - self.lo) / 1e9


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def short_name(name: str) -> str:
    """A kernel's name without its namespace prefix and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth, cut = 0, len(name)
    if name.endswith(")"):
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                cut = i
                break
    return name[:cut].strip()[:96]


def from_csrc(name: str) -> bool:
    """Kernels the program builds from its own CUDA sources: they sit in
    a top-level anonymous namespace, which PyTorch's and the libraries'
    kernels do not."""
    return re.sub(r"^void ", "", name).startswith("(anonymous namespace)::")


class Tracer:
    """``with Tracer(on) as tr: ... tr.range("bench/call") ...``; after the
    block, ``tr.trace`` holds the window (``bench/window``) or None."""

    def __init__(self, on: bool):
        self.on = on
        self.trace = None
        self._prof = None

    def range(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = read(self._prof)
        self._prof = None
        return False


def read(prof) -> Trace:
    from torch.autograd import DeviceType
    ops, ranges, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        span = (name, e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation() or name.startswith(PREFIX)
                    or name.startswith("Activity Buffer")):
                ops.append(span)
        elif name.startswith(PREFIX):
            if name == PREFIX + "window":
                window = span
            else:
                ranges.append(span)
    if window is None:
        raise RuntimeError("the trace has no bench/window range")
    _, lo, hi = window
    return Trace([o for o in ops if o[1] >= lo and o[2] <= hi],
                 [r for r in ranges if r[1] >= lo and r[2] <= hi], lo, hi)
