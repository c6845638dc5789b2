"""Guarded ingest: enforce the voxel data properties at the boundary.

Spira's speed rests on the paper's three structural properties — coordinates
are *integer-valued*, *bounded* and geometrically continuous — and the whole
packed-native pipeline assumes the first two: ``packing.pack`` shifts raw
components into bit fields with no bounds check, so a single negative or
out-of-range component silently bleeds into the neighboring field (voxel
aliasing — and, past the guard band, potential cross-scene kernel-map
matches), and NaN/Inf feature rows would flow unchecked through the fused
dataflows into every downstream consumer of the batch.

This module turns those documented contracts into *enforced* ones at the one
place raw data enters the engine (``SparseTensor.from_point_cloud``):

* coordinates must be integer-valued and inside ``BitLayout.data_range()``
  = ``[guard, 2^b - guard)`` per field (the guard-band contract in
  ``packing``'s module docstring);
* feature rows must be finite.

Three policies (``validate=``):

* ``"reject"`` (default) — raise :class:`ValidationError` with category
  counts and the first offending row; one poisoned scene never reaches the
  device.
* ``"clip"``  — clamp coordinates into the valid range (non-finite
  coordinate components go to the range floor), zero non-finite feature
  rows; degraded but servable.
* ``"drop"``  — remove offending rows entirely.
* ``"none"``  — skip validation (trusted in-process callers only).

Every path returns a :class:`ValidationReport` so serving can export
poisoned-input counters without re-scanning.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .packing import BitLayout

POLICIES = ("reject", "clip", "drop", "none")


@dataclasses.dataclass
class ValidationReport:
    """Per-ingest accounting of the guarded boundary (counts of rows)."""

    policy: str
    n_points: int = 0
    n_ok: int = 0
    n_aliased: int = 0       # out-of-field: would bleed into a neighbor field
    n_out_of_guard: int = 0  # in-field but inside the guard band
    n_nonfinite: int = 0     # NaN/Inf feature row (or coordinate component)
    n_noninteger: int = 0    # fractional voxel coordinate
    n_clipped: int = 0       # rows modified by policy="clip"
    n_dropped: int = 0       # rows removed by policy="drop"

    @property
    def n_bad(self) -> int:
        """Rows violating at least one contract (categories can overlap, so
        this is tracked exactly, not summed from the category counts)."""
        return self.n_points - self.n_ok

    @property
    def ok(self) -> bool:
        return self.n_bad == 0

    def merged(self, other: "ValidationReport") -> "ValidationReport":
        """Batch aggregation: per-scene reports sum field-wise."""
        kw = {f.name: getattr(self, f.name) + getattr(other, f.name)
              for f in dataclasses.fields(self) if f.name != "policy"}
        return ValidationReport(policy=self.policy, **kw)

    def summary(self) -> str:
        return (f"{self.n_bad}/{self.n_points} invalid rows "
                f"(aliased={self.n_aliased}, guard={self.n_out_of_guard}, "
                f"nonfinite={self.n_nonfinite}, "
                f"noninteger={self.n_noninteger}; clipped={self.n_clipped}, "
                f"dropped={self.n_dropped}, policy={self.policy!r})")


class ValidationError(ValueError):
    """Raised by ``validate="reject"`` (and by malformed shapes under any
    policy). Carries the :class:`ValidationReport` and — when raised while
    packing a batch — the offending scene index, so a serving engine can
    quarantine exactly one request."""

    def __init__(self, message: str, report: Optional[ValidationReport] = None,
                 scene_index: Optional[int] = None):
        super().__init__(message)
        self.report = report
        self.scene_index = scene_index


def _first_bad(coords: np.ndarray, bad: np.ndarray) -> str:
    i = int(np.argmax(bad))
    return f"first offending row {i}: coords={coords[i].tolist()}"


def validate_point_cloud(
    coords, features, layout: BitLayout, policy: str = "reject",
) -> Tuple[np.ndarray, np.ndarray, ValidationReport]:
    """Screen one scene's raw (coords, features) against the layout contract.

    Returns sanitized ``(coords int64 [N', 3], features [N', C], report)``
    per the module-doc policies. Host-side (numpy) — this runs inside the
    constructors' one-time packing step, never under jit.
    """
    if policy not in POLICIES:
        raise ValueError(f"validate= must be one of {POLICIES}, got "
                         f"{policy!r}")
    coords = np.asarray(coords)
    features = np.asarray(features)
    n = coords.shape[0]
    if policy == "none":
        return (coords, features,
                ValidationReport(policy=policy, n_points=n, n_ok=n))

    cf = coords.astype(np.float64)
    coord_finite = np.isfinite(cf).all(axis=1)
    cf = np.nan_to_num(cf, nan=0.0, posinf=0.0, neginf=0.0)
    noninteger = (cf != np.floor(cf)).any(axis=1)
    ci = np.floor(cf).astype(np.int64)

    lo = np.array([r[0] for r in layout.data_range()], np.int64)
    hi = np.array([r[1] for r in layout.data_range()], np.int64)
    field_hi = np.array([1 << layout.bx, 1 << layout.by, 1 << layout.bz],
                        np.int64)
    aliased = ((ci < 0) | (ci >= field_hi)).any(axis=1) | ~coord_finite
    out_of_guard = (~aliased) & ((ci < lo) | (ci >= hi)).any(axis=1)
    if np.issubdtype(features.dtype, np.floating):
        nonfinite = ~np.isfinite(
            features.reshape(n, -1)).all(axis=1)
    else:
        nonfinite = np.zeros(n, bool)
    bad = aliased | out_of_guard | nonfinite | noninteger

    report = ValidationReport(
        policy=policy, n_points=n, n_ok=int((~bad).sum()),
        n_aliased=int(aliased.sum()), n_out_of_guard=int(out_of_guard.sum()),
        n_nonfinite=int(nonfinite.sum()), n_noninteger=int(noninteger.sum()))

    if not bad.any():
        return ci, features, report

    if policy == "reject":
        rng = ", ".join(f"{ax}∈[{int(l)}, {int(h)})"
                        for ax, l, h in zip("xyz", lo, hi))
        raise ValidationError(
            f"point cloud violates the voxel data contract: "
            f"{report.summary()}. {_first_bad(coords, bad)}. Valid "
            f"guard-biased coordinate ranges for this layout: {rng}; "
            f"features must be finite. Fix the producer, or ingest with "
            f"validate='clip' (clamp + zero) or validate='drop' (remove "
            f"rows).", report=report)

    if policy == "clip":
        clipped = np.clip(ci, lo, hi - 1)
        f = features.copy()
        if nonfinite.any():
            f[nonfinite] = 0
        report.n_clipped = int(((clipped != ci).any(axis=1) | nonfinite
                                | noninteger).sum())
        return clipped, f, report

    keep = ~bad
    report.n_dropped = int(bad.sum())
    return ci[keep], features[keep], report
