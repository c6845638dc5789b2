"""Model assembly: the decoder LM over superblocks.

The port of ``repro/models/transformer.py`` for the dense ``("attn",
"dense")`` stacks. Parameters keep the reference's tree: per-layer leaves
stacked on a leading layer axis under ``"sb<i>"`` / ``"b<j>"`` /
``"f<j>"``, so a JAX tree converts leaf for leaf
(``convert.lm_params_from_jax``); the layers run in a Python loop over
views of those stacks (PyTorch runs eagerly: no ``scan``).

Entry points:
  init_params(...)      parameters from a seeded ``torch.Generator``
  forward(...)          full-sequence logits
  init_decode_state     static-size per-layer KV caches
  prefill(...)          populate caches from a prompt
  decode_step(...)      one-token serve step (caches updated in place)

``backend`` ("auto" | "torch" | "cuda") picks the flash attention kernel or
its plain version for the full-sequence attention calls
(``kernels.ops.resolve_backend``). Mamba, mLSTM and sLSTM blocks, MoE FFNs
and embedding-input archs are not ported yet (ROADMAP Queue 1 item 10) and
raise ``NotImplementedError``; so does the loss, which waits for LM
training.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

from . import layers
from .common import ModelConfig, ParamCtx, rms_norm

_TODO = "not ported yet (ROADMAP Queue 1 item 10)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot run yet."""
    if cfg.embedding_inputs:
        raise NotImplementedError(f"{cfg.name}: embedding-input archs are "
                                  + _TODO)
    for sb in cfg.superblocks:
        for kind, ffn in sb.blocks:
            if kind != "attn":
                raise NotImplementedError(f"{cfg.name}: {kind} blocks are "
                                          + _TODO)
            if ffn not in ("dense", "none"):
                raise NotImplementedError(f"{cfg.name}: {ffn} FFNs are "
                                          + _TODO)


def _layers(params: dict, cfg: ModelConfig
            ) -> Iterator[Tuple[str, int, str, dict, str, dict]]:
    """Every sub-layer in order: (superblock key, layer index, block key,
    attention params, FFN kind, FFN params), the params as views."""
    for si, sb in enumerate(cfg.superblocks):
        stack = params[f"sb{si}"]
        for r in range(sb.repeat):
            for bi, (_, ffn) in enumerate(sb.blocks):
                blk = {k: t[r] for k, t in stack[f"b{bi}"].items()}
                fp = ({k: t[r] for k, t in stack[f"f{bi}"].items()}
                      if ffn == "dense" else {})
                yield f"sb{si}", r, f"b{bi}", blk, ffn, fp


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters on ``device`` from ``torch.Generator(seed)`` with
    the reference's distributions (``ParamCtx``), in ``cfg.dtype``."""
    check_supported(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ctx = ParamCtx(gen, cfg.param_dtype, device)
    params: Dict[str, object] = {
        "embed": ctx.param((cfg.vocab, cfg.d_model), scale=0.02),
        "final_norm": ctx.param((cfg.d_model,), init="zeros")}
    if not cfg.tie_embeddings:
        params["lm_head"] = ctx.param((cfg.d_model, cfg.vocab))
    for si, sb in enumerate(cfg.superblocks):
        stacked = ParamCtx(gen, cfg.param_dtype, device, stack=sb.repeat)
        p = {}
        for bi, (_, ffn) in enumerate(sb.blocks):
            p[f"b{bi}"] = layers.attn_init(stacked, cfg)
            if ffn == "dense":
                p[f"f{bi}"] = layers.ffn_init(stacked, cfg)
        params[f"sb{si}"] = p
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed_inputs(params: dict, cfg: ModelConfig, batch: dict
                  ) -> torch.Tensor:
    """batch: ``{"tokens": [B, S]}`` (integer ids)."""
    check_supported(cfg)
    if batch.get("embeds") is not None:
        raise NotImplementedError("embedding inputs are " + _TODO)
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    return params["embed"].to(cfg.param_dtype)[tokens.long()]


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            backend: str = "auto") -> torch.Tensor:
    """Full-sequence logits ``[B, S, vocab]``."""
    x = _embed_inputs(params, cfg, batch)
    positions = _positions(x)
    for _, _, _, bp, ffn, fp in _layers(params, cfg):
        x = layers.attn_fwd(bp, cfg, x, positions, backend=backend)
        if ffn == "dense":
            x = layers.ffn_fwd(fp, cfg, x)
    return _logits(params, cfg, x)


def loss_fn(*args, **kwargs):
    raise NotImplementedError("the LM loss waits for LM training: " + _TODO)


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int, *,
                      device="cuda") -> dict:
    """Zero KV caches, ``{"sb<i>": {"b<j>": {"k", "v"}}}`` with leaves
    ``[repeat, batch, cache_len, n_kv, head_dim]`` in ``cfg.dtype``."""
    check_supported(cfg)
    state = {}
    for si, sb in enumerate(cfg.superblocks):
        state[f"sb{si}"] = {
            f"b{bi}": {k: torch.stack([t] * sb.repeat)
                       for k, t in layers.attn_init_cache(
                           cfg, batch, cache_len, cfg.param_dtype,
                           device).items()}
            for bi in range(len(sb.blocks))}
    return state


def prefill(params: dict, cfg: ModelConfig, batch: dict, cache_len: int, *,
            backend: str = "auto") -> Tuple[torch.Tensor, dict]:
    """Run the prompt through the model: (logits of the last position
    ``[B, 1, vocab]``, decode state with the prompt's KV cached)."""
    x = _embed_inputs(params, cfg, batch)
    positions = _positions(x)
    state = init_decode_state(cfg, x.shape[0], cache_len, device=x.device)
    for sk, r, bk, bp, ffn, fp in _layers(params, cfg):
        x, cache = layers.attn_prefill(bp, cfg, x, positions, cache_len,
                                       backend=backend)
        for name, c in cache.items():
            state[sk][bk][name][r] = c
        if ffn == "dense":
            x = layers.ffn_fwd(fp, cfg, x)
    return _logits(params, cfg, x[:, -1:]), state


def decode_step(params: dict, cfg: ModelConfig, state: dict, batch: dict,
                pos) -> Tuple[torch.Tensor, dict]:
    """One token for the whole batch: ``batch = {"tokens": [B, 1]}``;
    ``pos`` the count of already-cached tokens (scalar or per slot
    ``[B]``). Writes the new keys and values into ``state`` in place and
    returns (logits ``[B, 1, vocab]``, state)."""
    x = _embed_inputs(params, cfg, batch)
    pos = torch.as_tensor(pos, device=x.device)
    for sk, r, bk, bp, ffn, fp in _layers(params, cfg):
        cache = {k: t[r] for k, t in state[sk][bk].items()}
        x, _ = layers.attn_step(bp, cfg, x, cache, pos)
        if ffn == "dense":
            x = layers.ffn_fwd(fp, cfg, x)
    return _logits(params, cfg, x), state
