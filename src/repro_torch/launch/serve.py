"""Serving launcher: mesh + sharded params + the slot engine for an --arch
config.

  python -m repro_torch.launch.serve --arch yi-9b [--smoke] \
      [--mesh host|16x16|2x16x16] [--device cuda|cpu] --requests 8 \
      --slots 4 --cache-len 256 --max-new 16

Every token architecture serves: dense, MoE (qwen3-moe, kimi-k2), the
Jamba hybrid and xLSTM. Embedding-input archs (musicgen, pixtral) need a
frontend driver and are refused, as the JAX launcher refuses them. Random
weights from seed 0; prompts of 4-47 random tokens drawn as the JAX
launcher draws them. It runs on the card unless ``--device cpu``; the
full-sequence attention of every prefill runs the flash attention kernel
there (head dims 64, 128 or 256: the smoke configs' narrow heads run on
the CPU only).

As the reference's launcher, it serves under a mesh (``launch.train``'s
process-group rules; ``--mesh host`` is ``(1, 1)`` on one process). On
several ranks the parameters are placed by their logical axes with no
FSDP (tensor and expert parallelism over the model axis); the engine's
caches stay whole on every rank and its decode step runs eagerly: a CUDA
graph does not capture DTensor steps. On one rank the parameters stay
plain tensors (every placement would be whole: the same result) and the
decode step runs as one CUDA graph on the card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import configs
from ..dist.sharding import distribute_params, sharding_ctx
from ..models import transformer as tf
from ..serve.engine import Request, ServeEngine
from .train import start_mesh


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="host")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    if cfg.embedding_inputs:
        raise SystemExit("embedding-input archs need a frontend driver; use "
                         "a token arch")
    owned = not dist.is_initialized()
    try:
        _serve(args, cfg, start_mesh(args.mesh, args.device))
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _serve(args, cfg, mesh) -> None:
    dev = (torch.device("cuda", torch.cuda.current_device())
           if args.device == "cuda" else torch.device("cpu"))
    sharded = mesh.size() > 1
    with sharding_ctx(mesh, fsdp=False):
        params, axes = tf.init_params(cfg, 0, device=dev)
        if sharded:
            params = distribute_params(params, axes)
        eng = ServeEngine(cfg, params, batch_slots=args.slots,
                          cache_len=args.cache_len, cuda_graphs=not sharded)
        rng = np.random.default_rng(0)
        reqs = [Request(prompt=rng.integers(0, cfg.vocab,
                                            (int(rng.integers(4, 48)),)
                                            ).astype(np.int32),
                        max_new=args.max_new)
                for _ in range(args.requests)]
        t0 = time.perf_counter()
        eng.run(list(reqs))
        if args.device == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    tot = sum(len(r.out) for r in reqs)
    where = (torch.cuda.get_device_name(dev) if args.device == "cuda"
             else "cpu")
    if dist.get_rank() == 0:
        print(f"{args.arch}: {args.requests} reqs, {tot} tokens, "
              f"{dt:.2f}s, {tot / dt:.1f} tok/s on {where}, mesh "
              + "x".join(str(n) for n in mesh.shape))


if __name__ == "__main__":
    main()
