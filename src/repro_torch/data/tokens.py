"""Deterministic, step-resumable synthetic token pipeline (the port's copy
of ``repro/data/tokens.py``; numpy only, the same batches bit for bit).

Every batch is a pure function of (seed, step), so restarting from a
checkpoint at step k replays exactly the same stream — the data-side half
of fault tolerance. Sequences come from a mixture of Zipf-distributed
unigrams and a repeated-phrase process so small LMs have real structure to
learn. Batches are numpy arrays; the model moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embed_dim: int = 0         # >0: also emit stub "embeds" prefix
    embed_prefix: int = 0


def batch_at(cfg: DataConfig, step: int) -> dict:
    """The batch of ``step``: ``tokens`` and ``labels`` ``[B, S]`` int32
    (labels the next tokens), with ``embed_prefix`` also ``embeds [B,
    prefix, embed_dim]`` fp32 and the tokens and labels cut to ``S -
    prefix``."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    # Zipf unigrams
    ranks = np.arange(1, V + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    toks = rng.choice(V, size=(B, S + 1), p=probs)
    # repeated phrases: copy a chunk forward (learnable bigram structure)
    for b in range(B):
        L = S // 4
        src = rng.integers(0, S - 2 * L)
        dst = src + L
        toks[b, dst: dst + L] = toks[b, src: src + L]
    out = {"tokens": toks[:, :-1].astype(np.int32),
           "labels": toks[:, 1:].astype(np.int32)}
    if cfg.embed_prefix:
        out["embeds"] = rng.normal(
            size=(B, cfg.embed_prefix, cfg.embed_dim)).astype(np.float32)
        out["labels"] = out["labels"][:, : S - cfg.embed_prefix]
        out["tokens"] = out["tokens"][:, : S - cfg.embed_prefix]
    return out


def stream(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1
