"""Point-cloud serving loop on the PyTorch port: request queue over one
session (``examples/pointcloud_serve.py`` on ``repro_torch``).

Per-scene requests of *varying sizes* arrive, get packed into batched
SparseTensors on the host (scene index in the layout's batch bits), run
through one SpiraSession call per batch on the card, and are answered with
per-scene logits on the scene's own voxels. Capacity bucketing inside the
session keeps the compile keys at one per bucket no matter how sizes vary.

The run doubles as the observability demo (``repro_torch.obs``): the
engine records onto the session's metrics registry, and the end of the run
prints the snapshot — rolling QPS, p50/p99 serve latency, per-outcome
counts.

Run:  PYTHONPATH=src python examples/torch_pointcloud_serve.py [--smoke]
      [--device cuda|cpu]      (cuda by default; there is no fallback)
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.data import scenes
from repro_torch.models import pointcloud as pc
from repro_torch.serve import (PointCloudRequest, PointCloudServeEngine,
                               compile_network)


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to run on the CPU)")
    return args


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> None:
    args = parse(argv)
    B = 2 if args.smoke else 4
    n_req = 2 * B
    extent = (28, 24, 16) if args.smoke else (96, 80, 36)

    net = pc.sparse_resnet21(in_channels=4, n_classes=20)
    pool = scenes.scene_batch(seed=2, batch=n_req, kind="indoor",
                              extent=extent, overlap=0.3)
    rng = np.random.default_rng(3)
    requests = []
    for sc in pool:
        # vary request sizes: drop a random fraction of each scene's voxels
        keep = rng.random(len(sc.coords)) < rng.uniform(0.5, 1.0)
        coords = sc.coords[keep]
        requests.append(PointCloudRequest(
            coords=coords,
            features=rng.normal(size=(len(coords), 4)).astype(np.float32)))

    session = compile_network(net, pool[0].layout, batch=B,
                              device=args.device)
    engine = PointCloudServeEngine(session)
    print(f"{session}\nserving {n_req} requests "
          f"({[len(r.coords) for r in requests]} voxels) in batches of {B}")

    engine.run(requests)                  # warm: builds each bucket once
    for r in requests:
        r.done, r.logits, r.voxels, r.outcome = False, None, None, "pending"
    b0 = engine.batches_run
    sync(args.device)
    t0 = time.perf_counter()
    engine.run(requests)
    sync(args.device)
    dt = time.perf_counter() - t0

    assert all(r.done and np.isfinite(r.logits).all() for r in requests)
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu")
    print(f"steady state on {where}: {n_req} scenes in "
          f"{engine.batches_run - b0} batches, {dt * 1e3:.1f} ms total = "
          f"{dt / n_req * 1e3:.1f} ms/scene")
    print(f"compile keys: {session.compile_count} "
          f"(requests sizes varied {min(len(r.coords) for r in requests)}–"
          f"{max(len(r.coords) for r in requests)})")
    print(f"request 0 answer: logits {requests[0].logits.shape} on "
          f"{requests[0].voxels.shape[0]} voxels ✓")

    # -- the metrics snapshot (engine + session share one registry) ---------
    snap = session.metrics.snapshot()
    lat = snap["histograms"]["serve_latency_ok"]
    wait = snap["histograms"]["serve_queue_wait"]
    print(f"metrics: qps(60s)={snap['rates']['serve_qps']:.2f}  "
          f"latency p50={lat['p50'] * 1e3:.2f}ms p99={lat['p99'] * 1e3:.2f}ms"
          f" ({lat['count']} served)  "
          f"queue_wait p99={wait['p99'] * 1e3:.2f}ms")
    outcomes = {k[len("serve_"):]: v for k, v in snap["counters"].items()
                if k.startswith("serve_")}
    print(f"outcome counts: {outcomes}")


if __name__ == "__main__":
    main()
