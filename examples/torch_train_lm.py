"""End-to-end LM training on the PyTorch port: a scaled-down
qwen3-style MoE for a few hundred steps on the synthetic pipeline, with
checkpointing (``examples/train_lm.py`` on ``repro_torch``).

The model family/config machinery is what the dry run lowers at 256/512
ranks; this runs the same code on one device. Loss should drop from
~ln(V) toward the structure floor of the synthetic stream. On the card
every step runs the flash attention kernels, forward and backward
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``; fp32 at the
config's head dim 32).

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
      [--ckpt-dir DIR] [--device cuda|cpu]  (cuda by default; no fallback)

``--smoke`` is accepted, as by every example, and changes nothing: the
configuration is the reference's mini one; pass ``--steps`` for a short
run.
"""
import argparse

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.data.tokens import DataConfig, stream
from repro_torch.models.common import moe_lm
from repro_torch.train import AdamWConfig, TrainConfig, train


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_lm_ckpt")
    ap.add_argument("--smoke", action="store_true",
                    help="accepted; the configuration is CI-sized already")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to run on the CPU)")
    return args


def main(argv=None) -> dict:
    """Runs the example; returns the final metrics and the checkpoint
    steps kept."""
    args = parse(argv)
    cfg = moe_lm("qwen3-mini", n_layers=4, d_model=128, n_heads=8, n_kv=4,
                 d_ff_expert=256, vocab=2048, n_experts=8, top_k=2,
                 head_dim=32, capacity_factor=1.5, dtype="float32")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=8, seed=0)
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps),
        remat=False, log_every=10, ckpt_every=50)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    print(f"training {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"{cfg.n_experts}e top-{cfg.top_k}, {args.steps} steps")
    params, opt, metrics = train(cfg, tcfg, stream(dcfg), n_steps=args.steps,
                                 ckpt_manager=mgr, device=args.device)
    mgr.wait()
    print(f"final loss {float(metrics['loss']):.4f}; "
          f"checkpoints at {args.ckpt_dir}: steps {mgr.steps()} ✓")
    return {"metrics": metrics, "ckpt_steps": mgr.steps()}


if __name__ == "__main__":
    main()
