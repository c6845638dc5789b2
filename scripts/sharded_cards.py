#!/usr/bin/env python3
"""yi-9b training on several cards of one host: the port's sharded step
(``repro_torch.dist.sharding``) against one card.

    torchrun --nproc-per-node 4 scripts/sharded_cards.py [--fp32] [--cpu]
    python3 scripts/sharded_cards.py --sensitivity

Default: yi-9b at full width cut to 16 layers (seq 2,048 x batch 4, remat,
bf16) for 3 steps on a (4, 1) ``("data", "model")`` mesh with FSDP and on
a (2, 2) mesh with FSDP and tensor parallelism, then the same 3 steps on
rank 0's card alone (plain tensors), then yi-9b at all 48 layers on (4, 1):
(loss, grad norm) and ms per step, the flash launches, each rank's peak
memory. ``--fp32``: one step of a 2-layer fp32 cut (512 x 4) on both
meshes against one card. ``--sensitivity`` (one process, one card): that
fp32 step's grad norm at batch 4, with ``grad_accum`` 2 and 4
(micro-batches as the ranks of a data axis compute them) and under 1e-7
and 1e-6 relative weight perturbations. ``--cpu``: gloo on the CPU at the
smoke size (heads widened to 64), a rehearsal. Every line ends with the
card's name and power limit; rank 0 prints, and writes the default run's
numbers to ``chiprun_out/four.json``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data.tokens import DataConfig, batch_at  # noqa: E402
from repro_torch.dist.sharding import (distribute_params,  # noqa: E402
                                       sharding_ctx)
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import SuperBlock  # noqa: E402
from repro_torch.train import (AdamWConfig, TrainConfig,  # noqa: E402
                               init_opt_state, make_train_step)

CPU = "--cpu" in sys.argv
DEV_TYPE = "cpu" if CPU else "cuda"
BATCH = 4


def card_name() -> str:
    if CPU:
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]


def yi(layers: int, dtype: str = "bfloat16"):
    full = configs.get_config("yi-9b", smoke=CPU)
    if CPU:
        full = dataclasses.replace(full, head_dim=64)
    return dataclasses.replace(
        full, name=f"yi-9b ({layers} layers)", dtype=dtype,
        superblocks=(SuperBlock(blocks=(("attn", "dense"),),
                                repeat=layers),))


def leaves(t):
    for v in t.values():
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


class Run:
    def __init__(self):
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.dev = (torch.device("cpu") if CPU else
                    torch.device("cuda", torch.cuda.current_device()))
        self.card = card_name()

    def log(self, *a):
        if self.rank == 0:
            print(*a, flush=True)

    def sync(self):
        if not CPU:
            torch.cuda.synchronize()
        if dist.is_initialized():
            dist.barrier()

    def step_fn(self, cfg, seq, accum=1):
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=BATCH,
                          seed=0)
        step = make_train_step(cfg, TrainConfig(remat=True,
                                                grad_accum=accum))
        return step, dcfg

    def sharded(self, cfg, mesh_shape, seq, steps):
        """(loss, grad norm) and ms per step, the launches, peaks."""
        step, dcfg = self.step_fn(cfg, seq)
        mesh = make_mesh(mesh_shape, ("data", "model"), DEV_TYPE)
        if not CPU:
            torch.cuda.reset_peak_memory_stats()
        with sharding_ctx(mesh, fsdp=True):
            p, axes = tf.init_params(cfg, 0, device=self.dev)
            p = distribute_params(p, axes)
            o = init_opt_state(p, AdamWConfig())
            self.sync()
            reset_launch_counts()
            out, ms = [], []
            for i in range(steps):
                t0 = time.perf_counter()
                p, o, m = step(p, o, batch_at(dcfg, i))
                out.append((float(m["loss"]), float(m["grad_norm"])))
                self.sync()
                ms.append((time.perf_counter() - t0) * 1e3)
            counts = launch_counts()
        peak = 0.0 if CPU else torch.cuda.max_memory_allocated() / 2**30
        peaks = [torch.zeros(1, device=self.dev) for _ in range(self.world)]
        dist.all_gather(peaks, torch.zeros(1, device=self.dev) + peak)
        del p, o
        if not CPU:
            torch.cuda.empty_cache()
        return out, ms, counts, [float(x) for x in peaks]

    def plain(self, cfg, seq, steps, accum=1, eps=0.0):
        step, dcfg = self.step_fn(cfg, seq, accum)
        p, _ = tf.init_params(cfg, 0, device=self.dev)
        if eps:
            g = torch.Generator(device=self.dev).manual_seed(1)
            for t in leaves(p):
                t.mul_(1 + eps * torch.randn(t.shape, generator=g,
                                             device=self.dev))
        o = init_opt_state(p, AdamWConfig())
        out, ms = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            p, o, m = step(p, o, batch_at(dcfg, i))
            out.append((float(m["loss"]), float(m["grad_norm"])))
            ms.append((time.perf_counter() - t0) * 1e3)
        del p, o
        if not CPU:
            torch.cuda.empty_cache()
        return out, ms


def meshes(r: Run) -> None:
    seq = 32 if CPU else 2048
    res = {"card": r.card, "world": r.world}
    c16 = yi(2 if CPU else 16)
    for shape in ((4, 1), (2, 2)):
        out, ms, counts, peaks = r.sharded(c16, shape, seq, 3)
        res[f"16-layer {shape}"] = dict(steps=out, ms=ms, peaks=peaks)
        r.log(f"[cards {c16.name} mesh {shape} fsdp] (loss, grad norm) per "
              f"step {out}; ms per step {[round(x, 1) for x in ms]}; flash "
              f"launches on rank 0: {counts['flash_attention']} forward, "
              f"{counts['flash_attention_bwd']} backward; peak GiB per rank "
              f"{[round(x, 2) for x in peaks]} | {r.card}")
    if r.rank == 0:
        out, ms = r.plain(c16, seq, 3)
        res["16-layer plain"] = dict(steps=out, ms=ms)
        r.log(f"[cards {c16.name} one card, plain] (loss, grad norm) per "
              f"step {out}; ms per step {[round(x, 1) for x in ms]} | "
              f"{r.card}")
    dist.barrier()
    cfull = yi(4 if CPU else 48)
    out, ms, counts, peaks = r.sharded(cfull, (4, 1), seq, 3)
    res["48-layer (4, 1)"] = dict(steps=out, ms=ms, peaks=peaks)
    r.log(f"[cards {cfull.name}, mesh (4, 1) fsdp] (loss, grad norm) per "
          f"step {out}; ms per step {[round(x, 1) for x in ms]}; tokens/s "
          f"{seq * BATCH / (np.median(ms[1:]) / 1e3):.0f}; flash launches "
          f"on rank 0: {counts['flash_attention']} forward, "
          f"{counts['flash_attention_bwd']} backward; peak GiB per rank "
          f"{[round(x, 2) for x in peaks]} | {r.card}")
    if r.rank == 0:
        os.makedirs("chiprun_out", exist_ok=True)
        with open("chiprun_out/four.json", "w") as f:
            json.dump(res, f, indent=1)


def fp32(r: Run) -> None:
    c2, seq = yi(2, "float32"), (32 if CPU else 512)
    ref = r.plain(c2, seq, 1)[0][0] if r.rank == 0 else None
    for shape in ((4, 1), (2, 2)):
        got = r.sharded(c2, shape, seq, 1)[0][0]
        if r.rank == 0:
            r.log(f"[cards fp32 {c2.name} seq {seq} mesh {shape}] (loss, "
                  f"grad norm) {got} against one card's {ref}: relative "
                  f"{abs(got[0] - ref[0]) / abs(ref[0]):.3e}, "
                  f"{abs(got[1] - ref[1]) / abs(ref[1]):.3e} | {r.card}")


def sensitivity(r: Run) -> None:
    c2, seq = yi(2, "float32"), (32 if CPU else 512)
    a = r.plain(c2, seq, 1)[0][0]
    r.log(f"[sens] batch {BATCH}: (loss, grad norm) {a} | {r.card}")
    for accum in (2, 4):
        c = r.plain(c2, seq, 1, accum=accum)[0][0]
        r.log(f"[sens] grad_accum={accum}: {c}, grad norm relative to batch "
              f"{BATCH} {abs(c[1] - a[1]) / a[1]:.3e}")
    for eps in (1e-7, 1e-6):
        c = r.plain(c2, seq, 1, eps=eps)[0][0]
        r.log(f"[sens] weights x (1 + {eps} N(0,1)): {c}, grad norm moves "
              f"{abs(c[1] - a[1]) / a[1]:.3e}")


def main() -> None:
    torch.set_grad_enabled(False)
    if "--sensitivity" in sys.argv:
        if not CPU:
            from repro_torch.kernels import _build
            _build.build()
        return sensitivity(Run())
    dist.init_process_group("gloo" if CPU else "nccl")
    if not CPU:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        from repro_torch.kernels import _build
        if dist.get_rank() == 0:
            _build.build()          # one build; the other ranks load it
        dist.barrier()
        _build.library()
    try:
        (fp32 if "--fp32" in sys.argv else meshes)(Run())
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
