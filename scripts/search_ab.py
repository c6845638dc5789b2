#!/usr/bin/env python3
"""Device time of the kernel-map searches of the PyTorch port on one card,
for the ``repro_torch`` package under a given source tree.

    python3 scripts/search_ab.py [--src ROOT] [--label NAME]

``ROOT`` (default: this checkout) holds ``src/repro_torch``; its kernels
are built from its own ``csrc``. The script records, through the public
search functions, every superwindow search of one MinkUNet-42 forward and
one CenterPoint-Large forward, and every per-group window search of one
CenterPoint-Large plan (engine ``"zdelta_cuda_window"``), on chip_smoke's
batch of two outdoor scenes (seed 0, extent (1024, 1024, 40)). Each
recorded search is then run with ``backend="cuda"``: 10 calls enqueued
behind a ~2 ms spin of the card between two CUDA events, so the host's
launch cost is hidden and the time is the device's, phase A included
(torch ops in some trees, in the kernel in others); beside it, the same
for one ``fill_(-1)`` of a map of the launch's shape, the time a launch
that did nothing but store its map would take. It prints one JSON line:
the card, per-path sums in ms, each launch's pair of times, and the
level-0 and level-4 MinkUNet-42 launches alone. To compare two trees, run them in turns in
one call on one card (parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def queued_ms(fn, reps: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def record(module, name: str, fn) -> list:
    """Run ``fn`` with ``module.name`` wrapped to record its calls."""
    calls = []
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)
    setattr(module, name, wrapped)
    try:
        fn()
    finally:
        setattr(module, name, orig)
    return calls


def timed(calls, search) -> list:
    """Device ms of each recorded search, and of one ``fill_(-1)`` of a map
    of its shape: the floor a launch that only stores its map would reach
    on this card."""
    import torch
    out = []
    for a, kw in calls:
        kw = {**kw, "backend": "cuda"}
        m, _ = search(*a, **kw)
        out.append((queued_ms(lambda: search(*a, **kw)),
                    queued_ms(lambda: m.fill_(-1))))
        del m
    return out


def summary(ms: list, what: str) -> dict:
    return {f"{what} ms": sum(t for t, _ in ms),
            f"{what} fill floor ms": sum(f for _, f in ms),
            f"{what} launches": len(ms),
            f"{what} per launch (ms, fill ms)": [
                (round(t, 4), round(f, 4)) for t, f in ms]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("search_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src) / "src"))
    torch.set_grad_enabled(False)
    from repro_torch.core.sparse_tensor import SparseTensor
    from repro_torch.data import scenes
    from repro_torch.kernels import zdelta_window as zw
    from repro_torch.models import pointcloud as pc
    from repro_torch.serve import compile_network
    if not zw.__file__.startswith(str(Path(args.src).resolve())):
        raise RuntimeError(f"imported {zw.__file__}, not under {args.src}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    batch = scenes.scene_batch(seed=0, batch=2, kind="outdoor",
                               extent=(1024, 1024, 40), overlap=0.5)
    result = {"label": args.label, "src": args.src, "card": card}
    for net, cin in ((pc.minkunet42(in_channels=4, n_classes=20), 4),
                     (pc.centerpoint_large(), 5)):
        rng = np.random.default_rng(1)
        clouds = [(sc.coords, rng.normal(size=(len(sc.coords), cin))
                   .astype(np.float32)) for sc in batch]
        sess = compile_network(net, batch[0].layout, batch=2, seed=0)
        st2 = SparseTensor.from_point_clouds(clouds, sess.layout)
        calls = record(zw, "zdelta_superwindow_search", lambda: sess(st2))
        ms = timed(calls, zw.zdelta_superwindow_search)
        result.update(summary(ms, f"{net.name} superwindow per forward"))
        if net.name == "minkunet42":
            levels = [s.m_out for s in net.specs]
            result["minkunet42 L0 launch ms"] = ms[0][0]
            result["minkunet42 L4 launch ms"] = ms[levels.index(4)][0]
        else:
            win = compile_network(net, sess.layout, batch=2,
                                  params=sess.params,
                                  engine="zdelta_cuda_window")
            calls = record(zw, "zdelta_window_search", lambda: win.plan(st2))
            ms = timed(calls, zw.zdelta_window_search)
            result.update(summary(ms, f"{net.name} window per plan"))
        del sess, st2
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
