"""The comparison that decides ``correct``: the program's answers against
the plain reference, which derives everything again from the raw inputs.

Inference (``closed``, ``open``): every kept answer's output coordinates
must be the reference's output level exactly (``coord_mismatch``), and its
logits lie within ``logit_gap`` of the reference's, as the largest
absolute difference over the largest reference logit of the call; the
health reports of all calls of the window must show no dropped pair, no
escalation and the expected bucket.

Training (``train``): the reference follows the trainer's first steps from
the same weights and batches. Per leaf a gap is the difference of the two
norms over the larger of the reference's norm of that leaf and of the
median leaf. Compared are the first step's loss (``loss_gap_step1``,
relative), the mean over the leaves of the first clipped gradient's gaps
(``grad_gap_mean``: at random init the full-depth gradients are
ill-conditioned, so single leaves swing from seed to seed) and the worst
leaf's gap of the change over the steps (``step_gap``). Leaves
whose reference gradient is under a thousandth of the median leaf's move
by round-off alone under AdamW and are left out of ``step_gap``.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import reference, work

F64 = torch.float64


def layout_bits(extent, batch: int, guard: int = 16) -> tuple:
    """(bb, bx, by, bz) of the smallest packed word holding the extent
    plus the guard band on each side, and the batch index."""
    need = [max(1, int(np.ceil(np.log2(max(2, int(n) + 2 * guard)))))
            for n in extent]
    bb = 0 if batch <= 1 else max(1, int(np.ceil(np.log2(batch))))
    return (bb, *need)


def decode(words: torch.Tensor, extent, batch: int) -> torch.Tensor:
    """(scene, x, y, z) rows of packed words: the scene in the most
    significant field, then x, y, z."""
    bb, bx, by, bz = layout_bits(extent, batch)
    w = words.to(torch.int64)
    z = w & ((1 << bz) - 1)
    y = (w >> bz) & ((1 << by) - 1)
    x = (w >> (bz + by)) & ((1 << bx) - 1)
    b = (w >> (bz + by + bx)) & ((1 << bb) - 1) if bb else torch.zeros_like(x)
    return torch.stack([b, x, y, z], dim=-1)


def _plan(batch, layers, device):
    return reference.build_plan(batch.coords, layers, device)


def _shape(plan, layers):
    """Pairs per offset column and (n_in, n_out) valid rows per layer."""
    return ([reference.layer_pairs(plan, L) for L in layers],
            [(plan.levels[L.m_in].keys.numel(),
              plan.levels[L.m_out].keys.numel()) for L in layers])


def infer(kept: Sequence[tuple], pool, layers, weights, cfg: dict,
          mix: dict, device, *, dtype=F64, want_work=False) -> tuple:
    """Checks of the kept answers ``(pool entry, words, logits)`` and, with
    ``want_work``, each pool entry's work terms (``work.call_work``)."""
    w = {k: v.to(dtype) for k, v in weights.items()}
    by_entry: Dict[int, List[tuple]] = {}
    for b, words, logits in kept:
        by_entry.setdefault(b, []).append((words, logits))
    entries = range(len(pool)) if want_work else sorted(by_entry)
    mismatch, gap, per_entry = 0, 0.0, {}
    for b in entries:
        plan = _plan(pool[b], layers, device)
        if want_work:
            pairs, rows = _shape(plan, layers)
            per_entry[b] = work.call_work(layers, pairs, rows,
                                          cfg["n_classes"])
        if b not in by_entry:
            continue
        feats = reference.input_rows(plan, pool[b].feats, device, dtype)
        with torch.no_grad():
            ref = reference.forward(plan, layers, feats, w).to(F64)
        want = plan.levels[layers[-1].m_out].keys
        for words, logits in by_entry[b]:
            got = reference.keys(decode(words.to(device), mix["extent"],
                                        mix["scenes_per_call"]))
            if got.shape != want.shape:
                mismatch += abs(got.numel() - want.numel()) + 1
                continue
            bad = int((got != want).sum())
            mismatch += bad
            if bad:
                continue
            gap = max(gap, logit_gap(logits, ref))
        del plan, ref
    return {"coord_mismatch": mismatch, "logit_gap": gap}, per_entry


def logit_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest absolute difference of ``got`` from the reference's
    logits over the largest reference logit."""
    ref = ref.to(F64)
    d = (got.to(ref.device, F64) - ref).abs().max()
    return float(d / ref.abs().max())


def train(readings: dict, pool, layers, weights, cfg: dict, mix: dict,
          device, *, dtype=F64, want_work=False) -> tuple:
    """Checks of the trainer's first steps against the reference's, the
    readings not compared, and with ``want_work`` each pool entry's work
    terms."""
    n = mix["checked_steps"]
    plans = [_plan(pool[j], layers, device) for j in range(n)]
    feats = [reference.input_rows(p, pool[j].feats, device, dtype)
             for j, p in enumerate(plans)]
    labels = [reference.input_rows(p, pool[j].labels, device, None).long()
              for j, p in enumerate(plans)]
    ref = reference.train_steps(plans, feats, labels, layers,
                                {k: v.to(dtype) for k, v in weights.items()},
                                reference.AdamW(**mix["opt"]))
    del plans
    g_ref = {k: float(torch.linalg.vector_norm(v.to(F64)))
             for k, v in ref["first_grad"].items()}
    c_ref = {k: float(torch.linalg.vector_norm(v.to(F64)))
             for k, v in ref["change"].items()}
    checks, notes = train_numbers(readings, ref["losses"], g_ref, c_ref)
    per_entry = {}
    if want_work:
        for b in range(len(pool)):
            pairs, rows = _shape(_plan(pool[b], layers, device), layers)
            per_entry[b] = work.call_work(layers, pairs, rows,
                                          cfg["n_classes"], train=True)
    return checks, notes, per_entry


def train_numbers(got: dict, ref_losses, g_ref: Dict[str, float],
                  c_ref: Dict[str, float]) -> tuple:
    """The numbers compared (``checks``) and those read but not compared
    (``notes``: the later steps' losses, which sound fp32 runs move as far
    as the controls do, and the worst and the median leaf of the first
    gradient, which overlap the control's; PERF.md gives the readings)."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref_losses)]
    g_med = statistics.median(g_ref.values())
    moved = [k for k, v in g_ref.items() if v >= 1e-3 * g_med]
    grad = _leaf_gaps(got["grad"], g_ref, g_ref)
    checks = {"loss_gap_step1": gaps[0],
              "grad_gap_mean": statistics.fmean(grad),
              "step_gap": worst_leaf(got["change"], c_ref, moved)}
    notes = {f"loss_gap_step{i + 1}": g for i, g in enumerate(gaps) if i}
    notes.update(grad_gap_worst=max(grad),
                 grad_gap_median=statistics.median(grad))
    return checks, notes


def _leaf_gaps(got: Dict[str, float], ref: Dict[str, float], names):
    """``|got - ref| / max(ref, median ref)`` of each leaf in ``names``."""
    names = list(names)
    med = statistics.median(ref[k] for k in names)
    return [abs(got[k] - ref[k]) / max(ref[k], med) for k in names]


def worst_leaf(got: Dict[str, float], ref: Dict[str, float], names) -> float:
    return max(_leaf_gaps(got, ref, names))
