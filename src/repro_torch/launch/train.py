"""Training launcher: the LM training loop for an --arch config on one card.

  python -m repro_torch.launch.train --arch yi-9b --steps 100 [--smoke] \
      [--seq-len 256] [--global-batch 8] [--ckpt-dir DIR] [--resume] \
      [--device cuda|cpu]

The reference's launcher (``repro/launch/train.py``) with its data
(``DataConfig``, seed 0), its ``TrainConfig`` (AdamW at lr 3e-4 over
``--steps``, remat unless ``--smoke``, a checkpoint every 50 steps and at
the last) and ``CheckpointManager(keep=3)``; ``--resume`` continues from
the newest checkpoint, the data stream from the step after it. Random
weights from seed 0. It runs on the card unless ``--device cpu``; the
attention's forward and backward run the flash kernels there (head dims
64, 128 or 256: the smoke configs' narrow heads run on the CPU only).

Refused with a message: ``--mesh`` other than ``host`` and ``--fsdp`` (one
card: the sharded launch is later work), and embedding-input
architectures (musicgen; their batches need a frontend, and the
reference's launcher fails on them).
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import configs
from ..ckpt import CheckpointManager
from ..data.tokens import DataConfig, batch_at
from ..models import transformer as tf
from ..train import AdamWConfig, TrainConfig, init_opt_state, make_train_step
from ..train.loop import checkpoint_trees, restore


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="host")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.mesh != "host" or args.fsdp:
        raise SystemExit("--mesh other than host and --fsdp need the sharded "
                         "launch (several cards), which the port does not "
                         "have yet; run on one card with --mesh host")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    if cfg.embedding_inputs:
        raise SystemExit("embedding-input archs need a frontend for their "
                         "batches; use a token arch")

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch, seed=0)
    tcfg = TrainConfig(opt=AdamWConfig(lr=3e-4, total_steps=args.steps),
                       remat=not args.smoke, ckpt_every=50)
    mgr = CheckpointManager(args.ckpt_dir, keep=3)

    params = tf.init_params(cfg, 0, device=args.device)
    opt = init_opt_state(params, tcfg.opt)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        params, opt, last = restore(mgr, params, opt)
        start = last + 1
        print(f"resumed from step {last}")

    step_fn = make_train_step(cfg, tcfg)
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu")
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch_at(dcfg, step))
        loss = float(metrics["loss"])            # waits for the step
        if step % tcfg.log_every == 0:
            print(f"step {step} loss {loss:.4f} "
                  f"{(time.perf_counter() - t0) * 1e3:.0f}ms on {where}")
        if step % tcfg.ckpt_every == 0 or step == args.steps - 1:
            mgr.save(step, *checkpoint_trees(params, opt))
    mgr.wait()
    print(f"done; checkpoints: {mgr.steps()}")


if __name__ == "__main__":
    main()
