"""End-to-end point-cloud inference through the session front door, on the
PyTorch port (``examples/pointcloud_inference.py`` on ``repro_torch``).

One call builds the session (spec resolution, capacity bucketing,
network-wide indexing — Spira §5.5 — and the feature pass, one CUDA graph
per bucket on the card); one call per request runs it:

    session = compile_network(net, layout, batch=4)
    logits  = session(SparseTensor.from_point_clouds(clouds, session.layout))

Demonstrates single-scene and batch-of-B inference on MinkUNet-42 at full
width, verifies the batched-vs-looped bit-identity contract, and prints
steady-state latency per scene. The default engine, ``zdelta_cuda``, runs
the superwindow search kernel; ``hash`` probes on the host, which a graph
cannot hold, so its session runs eagerly (``cuda_graphs=False``).

Run:  PYTHONPATH=src python examples/torch_pointcloud_inference.py [--smoke]
      [--engine zdelta_cuda|zdelta|bsearch|hash] [--device cuda|cpu]
      (cuda by default; there is no fallback)
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import SparseTensor
from repro_torch.data import scenes
from repro_torch.models import pointcloud as pc
from repro_torch.serve import compile_network


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny scenes / batch-of-2 for CI")
    ap.add_argument("--engine", default="zdelta_cuda",
                    choices=["zdelta_cuda", "zdelta", "bsearch", "hash"])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to run on the CPU)")
    return args


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> dict:
    """Runs the example; returns its steady-state ms per call (``single``,
    ``batch``) and per scene (``per_scene``)."""
    args = parse(argv)
    dev = args.device
    B = 2 if args.smoke else 4
    kind, extent = (("indoor", (48, 40, 24)) if args.smoke
                    else ("outdoor", (192, 192, 32)))

    net = pc.minkunet42(in_channels=4, n_classes=20)
    batch = scenes.scene_batch(seed=0, batch=B, kind=kind, extent=extent,
                               overlap=0.5)
    rng = np.random.default_rng(1)
    clouds = [(sc.coords,
               rng.normal(size=(len(sc.coords), 4)).astype(np.float32))
              for sc in batch]
    sizes = [len(c) for c, _ in clouds]
    print(f"MinkUNet-42, {B} {kind} scenes: {sizes} voxels, "
          f"engine={args.engine}")

    session = compile_network(net, batch[0].layout, batch=B,
                              engine=args.engine, device=dev,
                              cuda_graphs=args.engine != "hash")
    print(session)

    def timed(st):
        out = session(st)                  # warm (builds this bucket)
        sync(dev)
        t0 = time.perf_counter()
        out = session(st)
        sync(dev)
        return out, time.perf_counter() - t0

    # -- single scene --------------------------------------------------------
    st1 = SparseTensor.from_point_clouds(clouds[:1], session.layout,
                                         device=dev)
    out1, dt1 = timed(st1)
    n1 = int(out1.count)
    print(f"single scene : logits {tuple(out1.features.shape)} ({n1} valid "
          f"rows), steady-state {dt1 * 1e3:.1f} ms")

    # -- batch of B ----------------------------------------------------------
    st_b = SparseTensor.from_point_clouds(clouds, session.layout, device=dev)
    out_b, dt_b = timed(st_b)
    print(f"batch of {B}   : logits {tuple(out_b.features.shape)} "
          f"({int(out_b.count)} valid rows), steady-state "
          f"{dt_b * 1e3:.1f} ms = {dt_b / B * 1e3:.1f} ms/scene")
    print(f"compiled buckets: {session.compile_count}")

    # -- batched == looped, bitwise ------------------------------------------
    scene0 = out_b.unbatch()[0]
    np.testing.assert_array_equal(scene0.features[:n1].cpu().numpy(),
                                  out1.unbatch()[0].features[:n1].cpu()
                                  .numpy())
    finite = bool(torch.isfinite(out_b.features[:int(out_b.count)]).all())
    where = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    print(f"batched scene-0 logits == single-scene logits (bitwise) ✓, "
          f"finite={finite} on {where}")
    return {"single": dt1 * 1e3, "batch": dt_b * 1e3,
            "per_scene": dt_b / B * 1e3}


if __name__ == "__main__":
    main()
