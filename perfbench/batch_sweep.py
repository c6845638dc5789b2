"""The batch of a closed-loop cell: its traffic at several scenes per call
in one process, each batch's window with its scenes/s, ms a call, voxels
a call and the card's memory peak. The cell's mix keeps a fixed batch
(the knee: the smallest batch whose double adds under 5% scenes/s); this
finds it once.

    python3 perfbench/batch_sweep.py --workload CELL --seed N --seconds S \
        --batches B1 B2 ... [--scenes 32]

Each batch's pool holds at most ``--scenes`` scenes (at least one batch,
at most the mix's own pool), so the host's scene generation stays short.
The sweep stops at the first batch that fails, and says why.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "perfbench_cache" / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--batches", type=int, nargs="+", required=True)
    ap.add_argument("--scenes", type=int, default=32)
    a = ap.parse_args(argv)
    import torch
    torch.set_num_threads(4)
    from perfbench.lib import drivers, harness, inputs, system
    from perfbench.lib.trace import Tracer
    c = harness.cell(harness.read_json(ROOT / "BENCHMARK.json"), a.workload)
    if c.mix["loop"] != "closed":
        raise SystemExit(f"{a.workload} is not a closed-loop cell")
    net = system.network(c.cfg, c.layers)
    weights = inputs.weights(c.layers, c.cfg, a.seed, "cuda")
    for b in a.batches:
        mix = dict(c.mix, scenes_per_call=b,
                   pool=max(1, min(c.mix["pool"], a.scenes // b)))
        t = time.perf_counter()
        pool = inputs.pool(a.seed, mix, c.cfg)
        env = harness.Env(c.cfg, mix, net, weights, pool, a.seed, a.seconds,
                          "cuda", Tracer(False))
        torch.cuda.reset_peak_memory_stats()
        try:
            rec, sess = drivers.closed(env)
        except Exception as e:  # out of memory, or a kernel's limit
            print(json.dumps({"batch": b, "error": repr(e)[:400]}),
                  flush=True)
            return 1
        peak = torch.cuda.max_memory_allocated()
        print(json.dumps({
            "batch": b, "pool": mix["pool"], "calls": len(rec.calls),
            "scenes_per_s": rec.scenes / rec.window_s,
            "ms_per_call": 1e3 * rec.window_s / max(len(rec.calls), 1),
            "voxels_per_call": sum(p.voxels for p in pool) / len(pool),
            "memory_peak_bytes": peak, "health": rec.health,
            "seconds": time.perf_counter() - t}), flush=True)
        del rec, sess
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
