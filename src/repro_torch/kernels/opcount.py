"""The hooks through which the kernels and the models tell an operation
counter (``launch.op_analysis.OpCounter``) what they do. Outside a counter
every hook is a no-op.

* :func:`kernel` — a hand-written kernel's call, counted by its closed
  form (PERF.md's kernel table) whichever implementation runs inside;
* :func:`uncounted` — the counting's own arithmetic, not counted;
* :func:`trips` / :func:`fill` — a Python loop over a sequence counted
  for one trip times the trip count;
* :func:`attention_counts` / :func:`attention_stand_ins` — the flash
  kernels' closed form and stand-ins that record it.

They live beside the kernels so that the kernel layer and the models need
nothing of the launch tools: a counter registers itself in :data:`ACTIVE`.
"""
from __future__ import annotations

import contextlib
from typing import List

import torch

# the counters entered, innermost last (``OpCounter.__enter__`` appends)
ACTIVE: List = []


def counting() -> bool:
    """True inside an operation counter."""
    return bool(ACTIVE)


def _active():
    return ACTIVE[-1] if ACTIVE else None


def trips(seq):
    """``seq`` itself outside a counter (or under ``trips=False``); inside,
    its first element only, counted ``len(seq)`` times (the analogue of
    ``hlo_analysis.py``'s while-trip multipliers)."""
    c = _active()
    seq = list(seq)
    if c is None or not c.trips or len(seq) <= 1:
        yield from seq
        return
    with c.repeat(len(seq)):
        yield seq[0]


def fill(items: list, n: int) -> list:
    """``items`` padded to ``n`` entries with its last (what a loop under
    :func:`trips` appended once); ``items`` itself when it has them."""
    return items + [items[-1]] * (n - len(items)) if items else items


@contextlib.contextmanager
def kernel(name: str, flops: float, nbytes: float):
    """A hand-written kernel's call, counted by its closed form: what runs
    inside (the kernel or its plain version) is not counted."""
    c = _active()
    if c is None:
        yield
        return
    c.add(name, flops, nbytes)
    with c.paused():
        yield


@contextlib.contextmanager
def uncounted():
    """Inside a counter, what runs here is not counted (the counting's own
    arithmetic); outside, nothing changes."""
    c = _active()
    if c is None:
        yield
        return
    with c.paused():
        yield


def causal_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs the end-aligned causal mask keeps: row r sees
    ``clamp(r + skv - sq + 1, 0, skv)`` keys."""
    a, b = skv - sq + 1, skv            # row 0's count, row sq-1's count

    def tri(n: int) -> int:
        return n * (n + 1) // 2 if n > 0 else 0
    lo, hi = max(a, 1), min(b, skv)
    return (tri(hi) - tri(lo - 1) if hi >= lo else 0) + skv * max(
        0, b - max(a, skv + 1) + 1)


def attention_counts(q: torch.Tensor, k: torch.Tensor, causal: bool,
                     backward: bool):
    """(operations, bytes) of one flash attention call (PERF.md's kernel
    table): 4·B·H·P·D operations for P kept pairs forward, 2.5× that
    backward; q, k, v read and the output written (backward: q, k, v, the
    output, its gradient and the row lse read, dq, dk, dv written)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    pairs = causal_pairs(Sq, Skv) if causal else Sq * Skv
    ops = 4.0 * B * H * pairs * D * (2.5 if backward else 1.0)
    es = q.element_size()
    if backward:
        nbytes = es * (4 * q.numel() + 4 * k.numel()) + 4 * B * H * Sq
    else:
        nbytes = es * (2 * q.numel() + 2 * k.numel())
    return ops, nbytes


def attention_stand_ins():
    """``(forward, backward)`` with the flash kernels' interface that
    record the closed form in the active counter and return empty results
    of the kernels' shapes (only for counting: nothing is computed)."""
    def fwd(q, k, v, *, causal, scale, return_lse=False):
        ops, nb = attention_counts(q, k, causal, backward=False)
        _active().add("flash_attention", ops, nb)
        out = torch.empty_like(q)
        if not return_lse:
            return out
        B, Sq, H, _ = q.shape
        return out, torch.empty((B, H, Sq), dtype=torch.float32,
                                device=q.device)

    def bwd(q, k, v, out, dout, lse, *, causal, scale):
        ops, nb = attention_counts(q, k, causal, backward=True)
        _active().add("flash_attention_bwd", ops, nb)
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    return fwd, bwd
