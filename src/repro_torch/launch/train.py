"""Training launcher: mesh + sharded init + the LM training loop.

  python -m repro_torch.launch.train --arch yi-9b --steps 100 [--smoke] \
      [--mesh host|16x16|2x16x16] [--fsdp] [--seq-len 256] \
      [--global-batch 8] [--ckpt-dir DIR] [--resume] [--device cuda|cpu]

The reference's launcher (``repro/launch/train.py``) with its data
(``DataConfig``, seed 0), its ``TrainConfig`` (AdamW at lr 3e-4 over
``--steps``, remat unless ``--smoke``, a checkpoint every 50 steps and at
the last) and ``CheckpointManager(keep=3)``; ``--resume`` continues from
the newest checkpoint, the data stream from the step after it. Random
weights from seed 0, drawn whole on every rank and then distributed.

Every run is a mesh run, as the reference's. On several ranks the
parameters and AdamW moments are DTensors placed by their logical axes
(``dist.sharding``; ``--fsdp`` also shards the ``d_model_fsdp`` dims over
the data axis) and the batch is sharded on ``("pod", "data")``. ``--mesh
host`` is a ``(ranks, 1)`` ``("data", "model")`` mesh over the ranks that
exist; the production meshes need 256 or 512 ranks. On one process the
mesh is ``(1, 1)``, where every placement is whole: the parameters stay
plain tensors, which computes bitwise what DTensors would and without
their dispatch on the host. A
multi-process run is started one process per rank with the
``torch.distributed`` environment (``torchrun`` sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); without it the launcher
starts a one-process group (NCCL on the card, gloo with ``--device cpu``).
On the card the attention's forward and backward run the flash kernels on
each rank's heads (head dims 64, 128 or 256: the smoke configs' narrow
heads run on the CPU only). Rank 0 logs and writes the checkpoints.

Refused with a message: a mesh whose size is not the number of ranks, and
embedding-input architectures (musicgen; their batches need a frontend,
and the reference's launcher fails on them).
"""
from __future__ import annotations

import argparse
import math
import os
import time

import torch
import torch.distributed as dist

from .. import configs
from ..ckpt import CheckpointManager
from ..data.tokens import DataConfig, batch_at
from ..dist.sharding import distribute_params, sharding_ctx
from ..models import transformer as tf
from ..train import AdamWConfig, TrainConfig, init_opt_state, make_train_step
from ..train.loop import checkpoint_trees, restore
from .mesh import init_single, make_host_mesh, make_mesh, parse_mesh


def start_mesh(spec: str, device: str):
    """The process group (from the environment, else one process) and the
    mesh ``spec`` names over it; ``SystemExit`` when their sizes differ."""
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group("nccl" if device == "cuda" else "gloo")
        else:
            init_single(device)
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    shape, names = parse_mesh(spec)
    world = dist.get_world_size()
    if shape is None:
        return make_host_mesh(device_type=device)
    if math.prod(shape) != world:
        raise SystemExit(f"--mesh {spec} is a sharded launch over "
                         f"{math.prod(shape)} ranks; this run has {world}: "
                         "start one process per rank (torchrun), or use "
                         "--mesh host")
    return make_mesh(shape, names, device)


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

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    if cfg.embedding_inputs:
        raise SystemExit("embedding-input archs need a frontend for their "
                         "batches; use a token arch")
    owned = not dist.is_initialized()
    try:
        _train(args, cfg, start_mesh(args.mesh, args.device))
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, cfg, mesh) -> None:
    lead = dist.get_rank() == 0

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch, seed=0)
    tcfg = TrainConfig(opt=AdamWConfig(lr=3e-4, total_steps=args.steps),
                       remat=not args.smoke, ckpt_every=50)
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if args.device == "cuda" else torch.device("cpu"))

    with sharding_ctx(mesh, fsdp=args.fsdp):
        params, axes = tf.init_params(cfg, 0, device=dev)
        if mesh.size() > 1:
            params = distribute_params(params, axes)
        opt = init_opt_state(params, tcfg.opt)
        start = 0
        if args.resume and mgr.latest_step() is not None:
            params, opt, last = restore(mgr, params, opt)
            start = last + 1
            if lead:
                print(f"resumed from step {last}")

        step_fn = make_train_step(cfg, tcfg)
        where = (torch.cuda.get_device_name(dev) if args.device == "cuda"
                 else "cpu")
        shape = "x".join(str(n) for n in mesh.shape)
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch_at(dcfg, step))
            loss = float(metrics["loss"])            # waits for the step
            if lead and step % tcfg.log_every == 0:
                print(f"step {step} loss {loss:.4f} "
                      f"{(time.perf_counter() - t0) * 1e3:.0f}ms on {where}, "
                      f"mesh {shape}")
            if step % tcfg.ckpt_every == 0 or step == args.steps - 1:
                mgr.save(step, *checkpoint_trees(params, opt))
    mgr.wait()
    if lead:
        print(f"done; checkpoints: {mgr.steps()}")


if __name__ == "__main__":
    main()
