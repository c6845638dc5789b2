"""Mixture-of-Experts FFN: top-k routing with capacity-based scatter
dispatch.

The port of ``repro/models/moe.py``, with its semantics kept exactly: top-k
over the router's softmax computed in fp32 (ties to the lower expert index,
as ``jax.lax.top_k``), the gates renormalised; the rank of each (token,
choice) within its expert counted over the flattened ``[N·k, E]`` one-hot
in token-major order; choices at or beyond the capacity ``C`` dropped;
token ids scattered into an ``E·C`` slot table, embeddings gathered from
it; one batched GLU over ``[E, C, d]``; the results gathered back and
weighted by the gates. Every shape is static (``C`` follows from the token
count) and nothing is read on the host, so the decode step that runs it can
be captured as a CUDA graph.

The rank is an inclusive scan along the tokens of the one-hot's transpose
``[E, N·k]`` (a scan over the inner axis; the outer-axis ``cumsum`` is slow
on the card). The expert GEMMs are ``torch.bmm`` over the expert axis: the
reference computes them with XLA einsums, not a Pallas kernel. The port
runs on one card: there is no ``shard_act``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .common import ModelConfig, ParamCtx, act_fn, rms_norm

__all__ = ["moe_init", "capacity_for", "route", "moe_fwd",
           "aux_load_balance_loss"]


def moe_init(ctx: ParamCtx, cfg: ModelConfig) -> dict:
    dm, dff, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    p = {
        "norm": ctx.param((dm,), init="zeros"),
        "router": ctx.param((dm, E), scale=0.02),
        "wi": ctx.param((E, dm, 2, dff)),
        "wo": ctx.param((E, dff, dm)),
    }
    if cfg.n_shared_experts:
        sdff = dff * cfg.n_shared_experts
        p["swi"] = ctx.param((dm, 2, sdff))
        p["swo"] = ctx.param((sdff, dm))
    return p


def capacity_for(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, ties to the lower index (a stable sort; ``torch.topk`` does not
    promise the order of ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: dict, cfg: ModelConfig, h: torch.Tensor):
    """The router on normalised tokens ``h [N, d]``: (router logits ``[N,
    E]`` fp32, gates ``[N, k]`` in h's dtype, expert ids ``eidx [N, k]``,
    position of each choice within its expert ``pos [N, k]``, ``keep``: pos
    below the capacity)."""
    N = h.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    C = capacity_for(cfg, N)
    logits = h.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = _top_k(probs, k)
    gate = (gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)).to(h.dtype)
    # rank of (token, choice) among the choices of its expert before it, in
    # token-major order: an inclusive scan per expert along the flattened
    # choices, read back at the chosen expert, minus one
    flat = eidx.reshape(-1)
    onehot = torch.zeros((E, N * k), dtype=torch.int32, device=h.device)
    onehot.scatter_(0, flat[None], 1)
    cum = onehot.cumsum(1, dtype=torch.int32)
    pos = (cum.gather(0, flat[None])[0] - 1).reshape(N, k)
    return logits, gate, eidx, pos, pos < C


def moe_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    B, S, dm = x.shape
    E, k, dff = cfg.n_experts, cfg.top_k, cfg.d_ff_expert
    N = B * S
    C = capacity_for(cfg, N)

    h = rms_norm(x, p["norm"], cfg.norm_eps).reshape(N, dm)
    _, gate, eidx, pos, keep = route(p, cfg, h)

    # dispatch: token ids into the slot table (one sink row past E·C takes
    # the dropped choices), then the embeddings gathered
    dest = torch.where(keep, eidx * C + pos, E * C)
    tok_of = torch.arange(N, dtype=torch.int32,
                          device=x.device)[:, None].expand(N, k)
    slot_tok = torch.full((E * C + 1,), N, dtype=torch.int32,
                          device=x.device)
    slot_tok.scatter_(0, dest.reshape(-1), tok_of.reshape(-1))
    slot_tok = slot_tok[:E * C]
    hx = h.to(x.dtype)
    buf = torch.where((slot_tok < N)[:, None],
                      hx[slot_tok.clamp(0, N - 1).long()],
                      torch.zeros((), dtype=x.dtype, device=x.device))

    # batched expert GLU: "ecd,edgf->ecgf", then "ecf,efd->ecd"
    wi = p["wi"].to(x.dtype).reshape(E, dm, 2 * dff)
    gu = torch.bmm(buf.reshape(E, C, dm), wi).reshape(E, C, 2, dff)
    a = act_fn(cfg.act)(gu[:, :, 0]) * gu[:, :, 1]
    out_buf = torch.bmm(a, p["wo"].to(x.dtype)).reshape(E * C, dm)

    # gather back, weighted by the gates
    gathered = out_buf[dest.clamp(0, E * C - 1).long()]      # [N, k, dm]
    gathered = gathered * keep[..., None].to(x.dtype) * gate[..., None]
    out = gathered.sum(dim=1)

    if cfg.n_shared_experts:
        swi = p["swi"].to(x.dtype)
        sgu = (hx @ swi.reshape(dm, -1)).unflatten(-1, swi.shape[1:])
        out = out + (act_fn(cfg.act)(sgu[:, 0]) * sgu[:, 1]) \
            @ p["swo"].to(x.dtype)

    return x + out.reshape(B, S, dm)


def aux_load_balance_loss(logits: torch.Tensor, eidx: torch.Tensor,
                          E: int) -> torch.Tensor:
    """Switch-style auxiliary loss. As in the reference, the LM loss
    (``transformer.loss_fn``) does not add it."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(eidx[:, 0].long(), E).float().mean(0)
    return E * torch.sum(me * ce)
