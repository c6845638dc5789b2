"""The yardstick's closed forms: operations and bytes of each kernel family
from the pairs of the reference's kernel maps, and the card's peaks.

A sparse convolution over ``p`` valid (output, input) pairs does
``2 p Cin Cout`` useful operations, whichever kernel computes it. Its bytes
count each input once and each output once: the valid input rows, the
weights of its offset columns, the map's columns over the valid output rows
(int32) and the valid output rows. The bound of a launch is the larger of
its operations over the peak rate and its bytes over the peak bandwidth.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

# NVIDIA's H100 SXM data sheet, dense: TF32 is the fastest rate that takes
# fp32 operands, so no fp32 implementation can pass it
PEAKS = {"H100": {"flops": 495e12, "bytes": 3.35e12}}


def peak(device_kind: str) -> Optional[dict]:
    for key, p in PEAKS.items():
        if key in device_kind:
            return p
    return None


def _term(ops: float, nbytes: float) -> Dict[str, float]:
    return {"ops": float(ops), "bytes": float(nbytes)}


def call_work(layers: Sequence, pairs: Sequence[np.ndarray],
              rows: Sequence[tuple], n_classes: int, itemsize: int = 4,
              train: bool = False) -> Dict[str, list]:
    """Per kernel family a list of launch terms ``{"ops", "bytes"}`` for one
    call (a forward, or with ``train`` a training step: the forward, dF of
    every layer but the first through the same dataflow over the transposed
    map, and dW of every layer and of the head), and ``model`` holding the
    useful operations of the whole call. ``pairs[i]`` are layer i's valid
    pairs per offset column, ``rows[i]`` its ``(n_in, n_out)`` valid rows:
    a 1x1, a strided or a transposed layer counts from its pairs as any
    other. Biases, standardisation and residual adds are not counted."""
    fam: Dict[str, list] = {"os": [], "ws": [], "dw": [], "model": []}
    useful = 0.0
    for i, (L, p, (n_in, n_out)) in enumerate(zip(layers, pairs, rows)):
        osc = L.os_columns()
        for name, cols in (("os", osc), ("ws", ~osc)):
            kd = int(cols.sum())
            if not kd:
                continue
            ops = 2.0 * float(p[cols].sum()) * L.cin * L.cout
            w = kd * L.cin * L.cout * itemsize
            fam[name].append(_term(ops, n_in * L.cin * itemsize + w
                                   + n_out * kd * 4
                                   + n_out * L.cout * itemsize))
            useful += ops
            if train and i > 0:
                fam[name].append(_term(ops, n_out * L.cout * itemsize + w
                                       + n_in * kd * 4
                                       + n_in * L.cin * itemsize))
                useful += ops
        if train:
            kd = len(p)
            ops = 2.0 * float(p.sum()) * L.cin * L.cout
            fam["dw"].append(_term(ops, (n_in * L.cin + n_out * L.cout
                                         + kd * L.cin * L.cout) * itemsize
                                   + n_out * kd * 4))
            useful += ops
    c, n = layers[-1].cout, rows[-1][1]
    head = 2.0 * n * c * n_classes
    useful += head * (3 if train else 1)
    if train:
        fam["dw"].append(_term(head, (n * c + n * n_classes
                                      + c * n_classes) * itemsize + n * 4))
    fam["model"].append(_term(useful, 0.0))
    return fam


def bound_seconds(terms: Sequence[Dict[str, float]], pk: dict) -> float:
    """Least time of the launches: per launch the larger of its two
    bounds, summed."""
    return sum(max(t["ops"] / pk["flops"], t["bytes"] / pk["bytes"])
               for t in terms)


def total_ops(terms: Sequence[Dict[str, float]]) -> float:
    return sum(t["ops"] for t in terms)
