"""Serving launcher: the slot engine for an --arch config on one card.

  python -m repro_torch.launch.serve --arch yi-9b [--smoke] \
      [--device cuda|cpu] --requests 8 --slots 4 --cache-len 256 --max-new 16

Every token architecture serves: dense, MoE (qwen3-moe, kimi-k2), the
Jamba hybrid and xLSTM. Embedding-input archs (musicgen, pixtral) need a
frontend driver and are refused, as the JAX launcher refuses them. Random
weights from seed 0; prompts of 4-47 random tokens drawn as the JAX
launcher draws them. It runs on the card unless ``--device cpu``; the
full-sequence attention of every prefill runs the flash attention kernel
there (head dims 64, 128 or 256: the smoke configs' narrow heads run on
the CPU only).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..models import transformer as tf
from ..serve.engine import Request, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true")
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
    params = tf.init_params(cfg, 0, device=args.device)
    eng = ServeEngine(cfg, params, batch_slots=args.slots,
                      cache_len=args.cache_len)
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
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu")
    print(f"{args.arch}: {args.requests} reqs, {tot} tokens, {dt:.2f}s, "
          f"{tot / dt:.1f} tok/s on {where}")


if __name__ == "__main__":
    main()
