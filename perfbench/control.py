"""Readings of the controls that ``correct`` must reject, at a cell's own
size: the reference put in the program's place in the next precision
down (float32 with TF32 products, for the configurations' float32), and
for training the reference with half of each batch left out (the mean
taken over the rest). Each reading is the number the check compares,
against the float64 reference (``check.logit_gap``, ``check.train_numbers``),
one JSON line per seed, with whether the cell's limits catch it.

    python3 perfbench/control.py --workload CELL --seeds 1 2 3

Not part of a benchmark run; its readings set the upper end of each limit
(``PERF.md``).
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def infer_readings(c, seed: int, device) -> dict:
    import torch
    from perfbench.lib import check, inputs, reference
    pool = inputs.pool(seed, c.mix, c.cfg)
    w = inputs.weights(c.layers, c.cfg, seed, device)
    gap = 0.0
    for b in pool:
        plan = reference.build_plan(b.coords, c.layers, device)
        with torch.no_grad():
            ref = reference.forward(
                plan, c.layers,
                reference.input_rows(plan, b.feats, device, torch.float64),
                {k: v.double() for k, v in w.items()})
            reference.TF32["on"] = True
            low = reference.forward(
                plan, c.layers,
                reference.input_rows(plan, b.feats, device, torch.float32),
                w)
            reference.TF32["on"] = False
        gap = max(gap, check.logit_gap(low, ref))
    return {"logit_gap": gap}


def train_readings(c, seed: int, device) -> dict:
    import dataclasses

    import torch
    from perfbench.lib import check, inputs, reference
    pool = inputs.pool(seed, c.mix, c.cfg)
    w = inputs.weights(c.layers, c.cfg, seed, device)
    n = c.mix["checked_steps"]
    opt = reference.AdamW(**c.mix["opt"])

    def steps(batches, dtype):
        plans = [reference.build_plan(b.coords, c.layers, device)
                 for b in batches]
        feats = [reference.input_rows(p, b.feats, device, dtype)
                 for p, b in zip(plans, batches)]
        labels = [reference.input_rows(p, b.labels, device, None).long()
                  for p, b in zip(plans, batches)]
        return reference.train_steps(plans, feats, labels, c.layers,
                                     {k: v.to(dtype) for k, v in w.items()},
                                     opt)

    def norms(r):
        return ({k: float(v.double().norm()) for k, v in
                 r["first_grad"].items()},
                {k: float(v.double().norm()) for k, v in
                 r["change"].items()})

    def readings(r, ref):
        g, ch = norms(r)
        g_ref, c_ref = norms(ref)
        checks, notes = check.train_numbers(
            {"losses": r["losses"], "grad": g, "change": ch},
            ref["losses"], g_ref, c_ref)
        return {**checks, **notes}

    ref = steps(pool[:n], torch.float64)
    reference.TF32["on"] = True
    tf32 = steps(pool[:n], torch.float32)
    reference.TF32["on"] = False
    half = [dataclasses.replace(b, coords=b.coords[:1], feats=b.feats[:1],
                                labels=b.labels[:1]) for b in pool[:n]]
    halved = steps(half, torch.float32)
    return {"tf32": readings(tf32, ref), "half_batch": readings(halved, ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from perfbench.lib import harness
    c = harness.cell(harness.read_json(ROOT / "BENCHMARK.json"), a.workload)
    read = train_readings if c.mix["loop"] == "train" else infer_readings
    lim = c.limits["checks"]

    def caught(r):
        """One of the control's numbers passes its limit."""
        return any(v > lim[k] for k, v in r.items() if k in lim)
    for seed in a.seeds:
        got = read(c, seed, a.device)
        print(json.dumps({
            "workload": a.workload, "seed": seed, **got,
            "caught": ({k: caught(r) for k, r in got.items()}
                       if c.mix["loop"] == "train" else caught(got))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
