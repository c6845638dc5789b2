"""One run of one cell: inputs from the seed, the program's set-up and
warm-up, the measured window, the check against the plain reference, and
the result line.

Everything particular to a cell is data found by name: the cell in
``BENCHMARK.json``, its configuration ``configs/<config>.json`` with the
reference architecture ``configs/<config>.py`` beside it, its traffic
``mixes/<traffic>.json``, its check limits ``limits/<cell>.json`` and one
reader ``metrics/<metric>.py`` per metric.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional

import torch

from . import breakdown, check, drivers, inputs, system, work
from .trace import Tracer

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a traced run profiles at most this long: the profiler's record of a long
# eager window takes minutes to read, and the per-layer shares need no more
TRACE_SECONDS = 10.0


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace("-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    cell: dict
    cfg: dict
    mix: dict
    limits: dict
    layers: list
    end_to_end: list
    per_layer: list


def cell(manifest: dict, name: str, bench: Path = BENCH) -> Cell:
    """Everything the manifest and the data files say about one cell."""
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    cfg = read_json(bench.parent / cfg_entry["file"])
    arch = load_module((bench.parent / cfg_entry["file"]).with_suffix(".py")
                       ).layers(cfg)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    mix = read_json(bench / "mixes" / f"{w['traffic']}.json")
    return Cell(name, w, cfg, mix,
                read_json(bench / "limits" / f"{name}.json"), arch,
                [m for m in manifest["end_to_end"] if mine(m)],
                [m for m in manifest["per_layer"] if mine(m)])


def forbidden_modules(modules=None) -> list:
    """Top-level names of ``modules`` (default: this process's) that are
    JAX or the JAX package, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


@dataclasses.dataclass
class Env:
    """What a loop needs: the cell's data, the inputs and the tracer."""

    cfg: dict
    mix: dict
    net: object
    weights: dict
    pool: list
    seed: int
    seconds: float
    device: str
    tracer: Tracer
    rate: Optional[float] = None


@dataclasses.dataclass
class Ctx:
    """What a metric reader reads (``metrics/<name>.py``: ``read(ctx)``
    returns a number, or None where it finds nothing to read)."""

    kind: str                 # the mix's loop: closed, open or train
    setup_s: float
    window_s: float
    calls: int                # calls or steps in the window
    attempted: int            # requests due in the window (open loop)
    scenes: int
    latencies: list           # seconds, open loop
    counters: dict            # the program's own span over the window
    trace: object             # trace.Trace of a traced run, else None
    work: dict                # family -> launch terms over the window
    peak: Optional[dict]      # the card's peaks (work.PEAKS)


def run(name: str, seed: int, seconds: float, traced: bool, *,
        started: float, device: str = "cuda",
        manifest: Optional[dict] = None, bench: Path = BENCH) -> dict:
    """One run; returns the result (``print_result`` prints it)."""
    manifest = manifest or read_json(bench.parent / "BENCHMARK.json")
    c = cell(manifest, name, bench)
    chips = c.cell["chips"]
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        raise SystemExit(f"{name} needs {chips} CUDA device(s); "
                         f"found {torch.cuda.device_count()}")
    pool = inputs.pool(seed, c.mix, c.cfg)
    net = system.network(c.cfg, c.layers)
    weights = inputs.weights(c.layers, c.cfg, seed, device)
    tracer = Tracer(traced)
    env = Env(c.cfg, c.mix, net, weights, pool, seed,
              min(seconds, TRACE_SECONDS) if traced else seconds, device,
              tracer)
    rec, state = drivers.LOOPS[c.mix["loop"]](env)
    setup_s = rec.t0 - started
    cuda = torch.device(device).type == "cuda"
    peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    del state
    if cuda:
        torch.cuda.empty_cache()
    notes = {}
    if c.mix["loop"] == "train":
        checks, notes, per_entry = check.train(
            rec.train, pool, c.layers, weights, c.cfg, c.mix, device,
            want_work=traced)
    else:
        checks, per_entry = check.infer(rec.kept, pool, c.layers, weights,
                                        c.cfg, c.mix, device,
                                        want_work=traced)
        checks.update(rec.health)
    terms = {}
    for b in rec.calls if traced else ():
        for fam, t in per_entry[b].items():
            terms.setdefault(fam, []).extend(t)
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    ctx = Ctx(c.mix["loop"], setup_s, rec.window_s, len(rec.calls),
              rec.attempted, rec.scenes, rec.latencies, rec.counters,
              tracer.trace, terms, work.peak(kind))
    metrics = {}
    for m in (c.per_layer if traced else c.end_to_end):
        v = load_module(bench / "metrics" / f"{m['name']}.py").read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks["failed"] = rec.failed
    limits = c.limits["checks"]
    missing = sorted(set(limits) ^ set(checks))
    if missing:
        raise RuntimeError(f"checks and limits differ: {missing}")
    correct = all(checks[k] <= limits[k] for k in limits)
    result = {"correct": correct, "attempted": rec.attempted,
              "failed": rec.failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": chips, "memory_peak_bytes": int(peak_bytes)}}
    if traced and tracer.trace is not None:
        result["device"]["busy_s"] = breakdown.busy_s(tracer.trace)
        result["device"]["window_s"] = tracer.trace.seconds
        result["breakdown"] = breakdown.of(tracer.trace)
    result["card"] = power_limit() if cuda else None
    notes.update(rec.backlog)
    result["notes"] = notes
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in sorted(limits)}
    # last, once the check and every reader have run: whatever they or the
    # program loaded after the window is in sys.modules by now
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded in the run: {found}")
    return result


def print_result(result: dict) -> None:
    for k, v in result["notes"].items():
        print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
