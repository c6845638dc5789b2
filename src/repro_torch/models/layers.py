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
reference returns an updated copy) and returns the same dict.

Under a mesh (``dist.sharding_ctx`` with DTensor parameters) the
activations pass through ``shard_act`` at the reference's sites. The
full-sequence causal call runs per rank on its local batch and heads
through ``torch.distributed.tensor.experimental.local_map`` — the kernels
take plain tensors through ctypes — with the KV heads repeated to the
query heads first when the model axis splits the query heads more finely
than the KV heads (the reference's expanded-H layout); every other call is
the chunked math on DTensors, whose partitioning follows the scores'
constraint (heads, or the KV sequence under ``seq_shard``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from ..kernels.flash_attention import (NEG_INF, FlashAttentionFn,
                                       flash_attention, flash_attention_bwd,
                                       flash_attention_torch)
from ..dist.sharding import (is_dtensor, local_linear, mesh_axes,
                              placements_for, seq_shard_active, shard_act,
                              spec_for, whole)
from ..kernels.ops import resolve_backend
from ..kernels import opcount
from .common import (ModelConfig, ParamCtx, act_fn, matmul, proj, rms_norm,
                     rope)

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
    kernel. Under an operation counter (``kernels.opcount``) it is counted
    by the kernels' closed form instead. On DTensors that call runs per rank on
    its local heads (module doc). Every other call is the reference's
    chunked math, which autograd differentiates as it is."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qf = q * torch.tensor(1.0 / (D ** 0.5), dtype=q.dtype)
    full = (causal and kv_len is None and isinstance(q_offset, int)
            and q_offset == Sk - Sq)
    if full:
        counted = opcount.counting()
        if counted or resolve_backend(backend, q):
            fwd, bwd = (opcount.attention_stand_ins() if counted
                        else (flash_attention, flash_attention_bwd))
            return _on_local_heads(
                lambda a, b, c, _: _flash(a, b, c, fwd, bwd), qf, k, v)
    plain = functools.partial(_plain_attention, causal=causal,
                              q_offset=q_offset, kv_chunk=kv_chunk)
    if not is_dtensor(q):
        return plain(qf, k, v, kv_len)
    if seq_shard_active():
        # split-K decode: the cache is split over its sequence, the heads
        # whole; the softmax's max and sums reduce across the shards
        qf = qf.redistribute(qf.device_mesh, placements_for(
            spec_for(("batch",), q.shape), qf.device_mesh))
        return plain(qf, k, v, kv_len, on_scores=_kv_seq_scores)
    return _on_local_heads(plain, qf, k, v, kv_len)


def _plain_attention(q, k, v, kv_len, *, causal, q_offset, kv_chunk,
                     on_scores=None):
    return flash_attention_torch(q, k, v, causal=causal, scale=1.0,
                                 q_offset=q_offset, kv_len=kv_len,
                                 kv_chunk=kv_chunk, on_scores=on_scores)


def _kv_seq_scores(s: torch.Tensor) -> torch.Tensor:
    """The split-K decode's scores ``[B, KV, G, Sq, chunk]`` follow the
    sequence-sharded cache (the reference's site in its chunk loop)."""
    return shard_act(s, ("batch", None, None, None, "kv_seq"))


def _flash(q, k, v, fwd, bwd):
    """The kernel call on plain tensors: :class:`FlashAttentionFn` under
    autograd, the forward alone otherwise."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, fwd, bwd)
    return fwd(q, k, v, causal=True, scale=1.0)


def _on_local_heads(fn, q, k, v, kv_len=None):
    """``fn(q, k, v, kv_len)`` on plain tensors; on DTensors through
    ``local_map`` on each rank's batch and query heads (``("batch", None,
    "heads", None)``), k and v placed alike — repeated to H heads first
    when the heads' mesh axes do not divide KV, so that each rank's query
    heads find their KV heads locally — and a per-row ``kv_len`` split as
    the batch."""
    if not is_dtensor(q):
        return fn(q, k, v, kv_len)
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    k, v = (t if is_dtensor(t) else DTensor.from_local(
        t, mesh, (Replicate(),) * mesh.ndim) for t in (k, v))
    H, KV = q.shape[2], k.shape[2]
    qp = placements_for(spec_for(("batch", None, "heads", None), q.shape),
                        mesh)
    sizes = tuple(mesh_axes(mesh).values())
    split = math.prod(n for p, n in zip(qp, sizes) if p == Shard(2))
    if KV % split:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    q, k, v = (t.redistribute(mesh, qp) for t in (q, k, v))
    args, places = [q, k, v], [qp, qp, qp]
    if isinstance(kv_len, torch.Tensor) and kv_len.dim():
        lp = tuple(p if p == Shard(0) else Replicate() for p in qp)
        if not is_dtensor(kv_len):
            kv_len = distribute_tensor(kv_len, mesh, lp, src_data_rank=None)
        args.append(kv_len.redistribute(mesh, lp))
        places.append(lp)
        call = fn
    else:
        def call(a, b, c):
            return fn(a, b, c, kv_len)
    return local_map(call, out_placements=(qp,), in_placements=tuple(places),
                     device_mesh=mesh)(*args)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def attn_init(ctx: ParamCtx, cfg: ModelConfig) -> dict:
    H, KV, D, dm = cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.d_model
    return {
        "norm": ctx.param("norm", (dm,), ("d_model",), init="zeros"),
        "wq": ctx.param("wq", (dm, H, D), ("d_model_fsdp", "heads", None)),
        "wk": ctx.param("wk", (dm, KV, D),
                        ("d_model_fsdp", "kv_heads", None)),
        "wv": ctx.param("wv", (dm, KV, D),
                        ("d_model_fsdp", "kv_heads", None)),
        "wo": ctx.param("wo", (H, D, dm), ("heads", None, "d_model_fsdp")),
    }


def _proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhe->bshe")`` as one matmul (per rank under a mesh:
    ``dist.sharding.local_linear``)."""
    return proj(h, w)


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q = rope(_proj(h, p["wq"]), positions, cfg.rope_theta)
    k = rope(_proj(h, p["wk"]), positions, cfg.rope_theta)
    v = _proj(h, p["wv"])
    return q, k, v                                   # [B,S,H,D], [B,S,KV,D]×2


def _out_local(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    H, D, dm = wo.shape
    return o.flatten(-2) @ wo.to(o.dtype).reshape(H * D, dm)


def _out(p: dict, o: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("bshe,hed->bsd")`` as one matmul (o is in x's dtype)."""
    return local_linear(_out_local, o, p["wo"], k=2)


def attn_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, *, backend: str = "auto"
             ) -> torch.Tensor:
    """Full-sequence causal attention (training / prefill compute)."""
    q, k, v = _qkv(p, cfg, x, positions)
    q = shard_act(q, ("batch", "seq", "heads", None))
    o = grouped_attention(q, k, v, causal=True, backend=backend)
    return x + shard_act(_out(p, o, x), ("batch", "seq", "d_model"))


def attn_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, cache_len: int, *,
                 backend: str = "auto") -> Tuple[torch.Tensor, dict]:
    """Prefill: the same compute as :func:`attn_fwd`, also returning the KV
    cache padded with zeros to ``cache_len``."""
    q, k, v = _qkv(p, cfg, x, positions)
    q = shard_act(q, ("batch", "seq", "heads", None))
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
    _cache_write(kc, k, pos)
    _cache_write(vc, v, pos)
    kc = shard_act(kc, ("batch", "kv_seq", "kv_heads", None))
    vc = shard_act(vc, ("batch", "kv_seq", "kv_heads", None))
    o = grouped_attention(q, kc, vc, causal=False, kv_len=pos + 1,
                          kv_chunk=L)
    return x + _out(p, o, x), cache


def _write_rows(c: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                off: int = 0, total: Optional[int] = None) -> None:
    """Write ``new [B, 1, KV, D]`` at ``pos`` (scalar or ``[B]``) into the
    cache rows ``c [B, L, KV, D]`` in place (:func:`attn_step`'s rules);
    ``c`` holds rows ``off .. off + L`` of a cache of ``total`` rows (the
    whole cache by default), and a row outside them is not written."""
    B, L = c.shape[:2]
    total = L if total is None else total
    if pos.dim() == 0:
        at = (pos.clamp(0, total - 1) - off).reshape(1)
        if total == L:
            c.index_copy_(1, at, new)
        else:
            inside = (at >= 0) & (at < L)
            at = at.clamp(0, L - 1)
            c.index_copy_(1, at, torch.where(inside, new,
                                             c.index_select(1, at)))
    else:                          # per-slot positions: a batched scatter
        rows = torch.arange(B, device=c.device)
        at = pos.reshape(-1).long().expand(B) - off
        keep = ((at >= 0) & (at < L))[:, None, None]
        at = at.clamp(0, L - 1)
        c[rows, at] = torch.where(keep, new[:, 0], c[rows, at])


def _cache_write(c: torch.Tensor, new: torch.Tensor, pos: torch.Tensor
                 ) -> None:
    """:func:`_write_rows` into a cache; on DTensors each rank writes its
    own rows (batch, heads or sequence shard) through ``local_map``."""
    if not is_dtensor(c):        # a whole cache (the serving engine's)
        return _write_rows(c, whole(new), pos)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    mesh = c.device_mesh
    cp = tuple(c.placements)
    npl = tuple(Replicate() if p == Shard(1) else p for p in cp)
    seq = [i for i, p in enumerate(cp) if p == Shard(1)]
    total = c.shape[1]

    def local(cl, nl, *pl):
        off = mesh.get_coordinate()[seq[0]] * cl.shape[1] if seq else 0
        _write_rows(cl, nl, pl[0] if pl else pos, off, total)
        return cl
    args, places = [c, new.redistribute(mesh, npl)], [cp, npl]
    if pos.dim():
        lp = tuple(p if p == Shard(0) else Replicate() for p in cp)
        if not is_dtensor(pos):
            pos = distribute_tensor(pos.reshape(-1).expand(c.shape[0]),
                                    mesh, lp, src_data_rank=None)
        args.append(pos.redistribute(mesh, lp))
        places.append(lp)
    local_map(local, out_placements=(cp,), in_placements=tuple(places),
              device_mesh=mesh)(*args)


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
        "norm": ctx.param("norm", (dm,), ("d_model",), init="zeros"),
        "wi": ctx.param("wi", (dm, 2, dff), ("d_model_fsdp", None, "d_ff")),
        "wo": ctx.param("wo", (dff, dm), ("d_ff", "d_model_fsdp")),
    }


def ffn_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    gu = _proj(h, p["wi"])                             # [B, S, 2, d_ff]
    gu = shard_act(gu, ("batch", "seq", None, "d_ff"))
    a = act_fn(cfg.act)(gu[:, :, 0]) * gu[:, :, 1]
    out = matmul(a, p["wo"])
    return x + shard_act(out, ("batch", "seq", "d_model"))
