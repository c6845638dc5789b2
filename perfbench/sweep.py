"""The knee of an open-loop cell: its traffic at several offered rates in
one process, each rate's window (after the mix's pre-roll) with its p50,
p95, the requests waiting at the window's middle and at its end (a backlog
that grows is load over capacity), the longest wait and the mean service
time. The cell's mix keeps a fixed rate (4/5 of the highest rate served
without a growing backlog); this finds it once.

    python3 perfbench/sweep.py --workload CELL --seed N --seconds S \
        --rates R1 R2 ...
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    a = ap.parse_args(argv)
    from perfbench.lib import drivers, harness, inputs, stats, system
    from perfbench.lib.trace import Tracer
    c = harness.cell(harness.read_json(ROOT / "BENCHMARK.json"), a.workload)
    if c.mix["loop"] != "open":
        raise SystemExit(f"{a.workload} is not an open-loop cell")
    pool = inputs.pool(a.seed, c.mix, c.cfg)
    net = system.network(c.cfg, c.layers)
    weights = inputs.weights(c.layers, c.cfg, a.seed, "cuda")
    for rate in a.rates:
        env = harness.Env(c.cfg, c.mix, net, weights, pool, a.seed,
                          a.seconds, "cuda", Tracer(False), rate=rate)
        t = time.perf_counter()
        rec, sess = drivers.open_loop(env)
        n = rec.counters["call_count"]
        print(json.dumps({
            "rate": rate, "attempted": rec.attempted, "failed": rec.failed,
            "p50_ms": stats.percentile(rec.latencies, 50) * 1e3,
            "p95_ms": stats.percentile(rec.latencies, 95) * 1e3,
            **rec.backlog,
            "service_ms": 1e3 * rec.counters["call_seconds"] / max(n, 1),
            "served_per_s": len(rec.latencies) / rec.window_s,
            "seconds": time.perf_counter() - t}), flush=True)
        del sess
    return 0


if __name__ == "__main__":
    sys.exit(main())
