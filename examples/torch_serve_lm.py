"""Batched LM serving with the slot-based engine on the PyTorch port:
prefill + continuous batched decode, mixed prompt lengths, greedy +
sampled requests (``examples/serve_lm.py`` on ``repro_torch``).

On the card each prefill runs the flash attention kernel
(``csrc/flash_attention.cu``, fp32 at the config's head dim 16) and each
decode step replays one CUDA graph. Sampled requests draw from the
engine's ``torch.Generator`` (seed 0): the reference's distribution, not
its numbers.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py
      [--device cuda|cpu]      (cuda by default; there is no fallback)

``--smoke`` is accepted, as by every example, and changes nothing: the
configuration is the reference's mini one in both modes.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.models.common import dense_lm
from repro_torch.serve import Request, ServeEngine

REQUESTS = [(9, 0.0), (17, 0.0), (33, 0.8), (5, 0.0), (21, 0.0), (13, 0.8)]


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="accepted; the configuration is CI-sized already")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to run on the CPU)")
    return args


def config(make=dense_lm):
    """The reference example's ``serve-mini`` config (``make``: either
    package's ``dense_lm``)."""
    return make("serve-mini", n_layers=4, d_model=128, n_heads=8, n_kv=4,
                d_ff=256, vocab=512, dtype="float32")


def requests(vocab: int, make=Request) -> list:
    """The six requests: prompts from ``default_rng(0)``, 24 new tokens
    each, greedy (temperature 0) or sampled at 0.8."""
    rng = np.random.default_rng(0)
    return [make(prompt=rng.integers(0, vocab, (int(n),)).astype(np.int32),
                 max_new=24, temperature=t) for n, t in REQUESTS]


def serve(cfg, params) -> tuple:
    """Serve :func:`requests` on 4 slots; returns them and the seconds."""
    eng = ServeEngine(cfg, params, batch_slots=4, cache_len=128)
    reqs = requests(cfg.vocab)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(list(reqs))
    return reqs, time.perf_counter() - t0


def main(argv=None) -> dict:
    """Runs the example; returns its tokens, seconds and tokens/s."""
    args = parse(argv)
    cfg = config()
    params, _ = tf.init_params(cfg, 0, device=args.device)
    reqs, dt = serve(cfg, params)
    total_new = sum(len(r.out) for r in reqs)
    assert all(r.done and len(r.out) == r.max_new for r in reqs)
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu")
    print(f"{len(reqs)} requests on 4 slots -> {total_new} tokens "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s on {where}) ✓")
    for i, r in enumerate(reqs):
        print(f"  req{i} prompt[{len(r.prompt)}] -> {r.out[:8]}...")
    return {"tokens": total_new, "seconds": dt,
            "tokens_per_s": total_new / dt}


if __name__ == "__main__":
    main()
