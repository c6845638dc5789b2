"""Attention (GQA + RoPE) and dense GLU FFN blocks.

The port of ``repro/models/layers.py``. Attention keeps the grouped form
(G = H // KV query heads per KV head) without materialising repeated KV.
:func:`grouped_attention` does what the reference's docstring says its
Pallas kernel should do and the reference never wired: the full-sequence
causal calls (:func:`attn_fwd`, :func:`attn_prefill`) run the hand-written
flash attention kernel on a CUDA tensor, and under autograd its backward
kernel too. The decode step
(:func:`attn_step`: ``causal=False``, a per-slot ``kv_len`` over a padded
cache) is a different function, which the kernel's end-aligned diagonal
does not mask; it runs the reference's chunked online softmax
(``kernels.flash_attention.flash_attention_torch``) on every device, as the
JAX package runs it in XLA.

The decode step writes the new key and value into the cache in place (the
reference returns an updated copy) and returns the same dict. The port
runs on one card: there is no ``shard_act``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.flash_attention import (NEG_INF, FlashAttentionFn,
                                       flash_attention, flash_attention_bwd,
                                       flash_attention_torch)
from ..kernels.ops import resolve_backend
from .common import ModelConfig, ParamCtx, act_fn, rms_norm, rope

__all__ = ["NEG_INF", "grouped_attention", "attn_init", "attn_fwd",
           "attn_prefill", "attn_step", "attn_init_cache", "ffn_init",
           "ffn_fwd"]


def grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset=0,
                      kv_len: Optional[torch.Tensor] = None,
                      kv_chunk: int = 1024,
                      backend: str = "auto") -> torch.Tensor:
    """Softmax attention of q ``[B, Sq, H, D]`` over k, v ``[B, Sk, KV,
    D]``; returns ``[B, Sq, H, D]`` in q's dtype. q is scaled by ``1/√D``
    first, in q's dtype with the scale rounded to it (the reference's
    weak-typed multiply), so the kernel runs with scale 1. The causal
    full-sequence call (``q_offset == Sk - Sq``, no ``kv_len``) launches
    the flash attention kernel on a CUDA tensor unless ``backend`` is
    "torch"; under autograd (grad enabled, q, k or v requiring grad) it
    goes through :class:`FlashAttentionFn`, whose backward is the backward
    kernel. Every other call is the reference's chunked math, which
    autograd differentiates as it is."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qf = q * torch.tensor(1.0 / (D ** 0.5), dtype=q.dtype)
    full = (causal and kv_len is None and isinstance(q_offset, int)
            and q_offset == Sk - Sq)
    if full and resolve_backend(backend, q):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFn.apply(qf, k, v, flash_attention,
                                          flash_attention_bwd)
        return flash_attention(qf, k, v, causal=True, scale=1.0)
    return flash_attention_torch(qf, k, v, causal=causal, scale=1.0,
                                 q_offset=q_offset, kv_len=kv_len,
                                 kv_chunk=kv_chunk)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def attn_init(ctx: ParamCtx, cfg: ModelConfig) -> dict:
    H, KV, D, dm = cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.d_model
    return {
        "norm": ctx.param((dm,), init="zeros"),
        "wq": ctx.param((dm, H, D)),
        "wk": ctx.param((dm, KV, D)),
        "wv": ctx.param((dm, KV, D)),
        "wo": ctx.param((H, D, dm)),
    }


def _proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhe->bshe")`` as one matmul."""
    d, n, e = w.shape
    return (h @ w.to(h.dtype).reshape(d, n * e)).unflatten(-1, (n, e))


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q = rope(_proj(h, p["wq"]), positions, cfg.rope_theta)
    k = rope(_proj(h, p["wk"]), positions, cfg.rope_theta)
    v = _proj(h, p["wv"])
    return q, k, v                                   # [B,S,H,D], [B,S,KV,D]×2


def _out(p: dict, o: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("bshe,hed->bsd")`` as one matmul."""
    H, D, dm = p["wo"].shape
    return o.flatten(-2) @ p["wo"].to(x.dtype).reshape(H * D, dm)


def attn_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, *, backend: str = "auto"
             ) -> torch.Tensor:
    """Full-sequence causal attention (training / prefill compute)."""
    q, k, v = _qkv(p, cfg, x, positions)
    o = grouped_attention(q, k, v, causal=True, backend=backend)
    return x + _out(p, o, x)


def attn_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, cache_len: int, *,
                 backend: str = "auto") -> Tuple[torch.Tensor, dict]:
    """Prefill: the same compute as :func:`attn_fwd`, also returning the KV
    cache padded with zeros to ``cache_len``."""
    q, k, v = _qkv(p, cfg, x, positions)
    o = grouped_attention(q, k, v, causal=True, backend=backend)
    B, S = x.shape[:2]
    if S > cache_len:
        raise ValueError(f"prompt of {S} tokens does not fit a cache of "
                         f"{cache_len}")
    cache = {}
    for name, t in (("k", k), ("v", v)):
        c = t.new_zeros((B, cache_len) + tuple(t.shape[2:]))
        c[:, :S] = t
        cache[name] = c
    return x + _out(p, o, x), cache


def attn_step(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
              pos) -> Tuple[torch.Tensor, dict]:
    """Decode one token against a static-size KV cache, written in place.
    ``pos`` is the number of tokens already cached: a scalar, or ``[B]``
    for slot-batched serving (continuous batching). A scalar position past
    the cache writes its last row (the reference's clamped
    ``dynamic_update_slice``); a per-slot one past it writes nothing (its
    scatter drops out-of-range rows)."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device)
    positions = (pos.reshape(-1, 1) if pos.dim() else pos).expand(B, 1)
    q, k, v = _qkv(p, cfg, x, positions)
    kc, vc = cache["k"], cache["v"]
    L = kc.shape[1]
    if pos.dim() == 0:
        at = pos.clamp(0, L - 1)
        kc.index_copy_(1, at.reshape(1), k)
        vc.index_copy_(1, at.reshape(1), v)
    else:                          # per-slot positions: a batched scatter
        rows = torch.arange(B, device=x.device)
        at = positions[:, 0].long()
        keep = (at < L)[:, None, None]
        at = at.clamp(max=L - 1)
        for c, new in ((kc, k), (vc, v)):
            c[rows, at] = torch.where(keep, new[:, 0], c[rows, at])
    o = grouped_attention(q, kc, vc, causal=False, kv_len=pos + 1,
                          kv_chunk=L)
    return x + _out(p, o, x), cache


def attn_init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                    device="cuda") -> dict:
    shape = (batch, cache_len, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# dense GLU FFN
# ---------------------------------------------------------------------------

def ffn_init(ctx: ParamCtx, cfg: ModelConfig) -> dict:
    dm, dff = cfg.d_model, cfg.d_ff
    return {
        "norm": ctx.param((dm,), init="zeros"),
        "wi": ctx.param((dm, 2, dff)),
        "wo": ctx.param((dff, dm)),
    }


def ffn_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    gu = _proj(h, p["wi"])                             # [B, S, 2, d_ff]
    a = act_fn(cfg.act)(gu[:, :, 0]) * gu[:, :, 1]
    return x + a @ p["wo"].to(x.dtype)
