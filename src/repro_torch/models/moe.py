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
reference computes them with XLA einsums, not a Pallas kernel.

Under a mesh the slot buffer and the expert GEMMs' outputs pass through
``shard_act`` at the reference's sites (``("experts", "expert_cap",
...)``), and each rank runs the GLU of its own experts
(``_per_expert_rank``). The routing, the slot-table scatter and the
gather back run on the tokens of the whole batch, replicated on every
rank (``_replicated``): their scans and scatters cross the batch's
shards, which DTensor cannot partition.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..dist.sharding import is_dtensor, shard_act
from .common import (ModelConfig, ParamCtx, act_fn, matmul, proj,
                     rms_norm)

__all__ = ["moe_init", "capacity_for", "route", "moe_fwd",
           "aux_load_balance_loss"]


def moe_init(ctx: ParamCtx, cfg: ModelConfig) -> dict:
    dm, dff, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    p = {
        "norm": ctx.param("norm", (dm,), ("d_model",), init="zeros"),
        "router": ctx.param("router", (dm, E), ("d_model", None), scale=0.02),
        "wi": ctx.param("wi", (E, dm, 2, dff),
                        ("experts", "d_model_fsdp", None, "expert_ff")),
        "wo": ctx.param("wo", (E, dff, dm),
                        ("experts", "expert_ff", "d_model_fsdp")),
    }
    if cfg.n_shared_experts:
        sdff = dff * cfg.n_shared_experts
        p["swi"] = ctx.param("swi", (dm, 2, sdff),
                             ("d_model_fsdp", None, "d_ff"))
        p["swo"] = ctx.param("swo", (sdff, dm), ("d_ff", "d_model_fsdp"))
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


def _replicated(fn, n_out: int, *args):
    """``fn(*args)`` on plain tensors; on DTensors through ``local_map``
    with every argument replicated on every rank (all-gathered) and each of
    its ``n_out`` outputs replicated."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    rep = (Replicate(),) * mesh.ndim
    args = [a.redistribute(mesh, rep) if is_dtensor(a) else a for a in args]
    return local_map(fn, out_placements=(rep,) * n_out,
                     in_placements=tuple(rep if is_dtensor(a) else None
                                         for a in args),
                     device_mesh=mesh)(*args)


def _dispatch(p: dict, cfg: ModelConfig, h: torch.Tensor):
    """Route the tokens ``h [N, d]`` and fill the slot buffer: (``dest [N,
    k]`` each choice's slot, ``E·C`` for a dropped one; ``keep``; the
    gates; ``buf [E·C, d]``)."""
    N, dm = h.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity_for(cfg, N)
    _, gate, eidx, pos, keep = route(p, cfg, h)
    # dispatch: token ids into the slot table (one sink row past E·C takes
    # the dropped choices), then the embeddings gathered
    dest = torch.where(keep, eidx * C + pos, E * C)
    tok_of = torch.arange(N, dtype=torch.int32,
                          device=h.device)[:, None].expand(N, k)
    slot_tok = torch.full((E * C + 1,), N, dtype=torch.int32,
                          device=h.device)
    slot_tok.scatter_(0, dest.reshape(-1), tok_of.reshape(-1))
    slot_tok = slot_tok[:E * C]
    buf = torch.where((slot_tok < N)[:, None],
                      h[slot_tok.clamp(0, N - 1).long()],
                      torch.zeros((), dtype=h.dtype, device=h.device))
    return dest, keep, gate, buf


def _expert_glu(buf: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                act) -> torch.Tensor:
    """The batched expert GLU over the slot buffer ``buf [E, C, d]``:
    "ecd,edgf->ecgf", then "ecf,efd->ecd", in buf's dtype."""
    E, C, dm = buf.shape
    gu = torch.bmm(buf, wi.to(buf.dtype).reshape(E, dm, -1)).reshape(
        E, C, 2, -1)
    a = act(gu[:, :, 0]) * gu[:, :, 1]
    return torch.bmm(a, wo.to(buf.dtype))


def _per_expert_rank(fn, buf, wi, wo):
    """``fn(buf, wi, wo)`` on plain tensors; on DTensors through
    ``local_map``, each rank on its experts (the mesh dims that split wi's
    expert dim, the reference's ``("experts", ...)`` constraints), the
    weights' other splits (FSDP's) gathered."""
    if not is_dtensor(wi):
        return fn(buf, wi, wo)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = wi.device_mesh
    ep = tuple(Shard(0) if p == Shard(0) else Replicate()
               for p in wi.placements)
    args = [t.redistribute(mesh, ep) for t in (buf, wi, wo)]
    return local_map(fn, out_placements=(ep,), in_placements=(ep,) * 3,
                     in_grad_placements=(ep,) * 3, device_mesh=mesh)(*args)


def _combine(out_buf: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
             gate: torch.Tensor) -> torch.Tensor:
    """Gather the expert outputs ``out_buf [E, C, d]`` back to their
    tokens, weighted by the gates: ``[N, d]``."""
    out_buf = out_buf.reshape(-1, out_buf.shape[-1])
    gathered = out_buf[dest.clamp(0, out_buf.shape[0] - 1).long()]
    gathered = gathered * keep[..., None].to(out_buf.dtype) * gate[..., None]
    return gathered.sum(dim=1)


def moe_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    B, S, dm = x.shape
    E, N = cfg.n_experts, B * S
    C = capacity_for(cfg, N)

    h = rms_norm(x, p["norm"], cfg.norm_eps)
    dest, keep, gate, buf = _replicated(
        lambda h3, r: _dispatch({"router": r}, cfg, h3.reshape(N, dm)), 4,
        h, p["router"])
    buf = shard_act(buf.reshape(E, C, dm), ("experts", "expert_cap", None))

    out_buf = _per_expert_rank(
        lambda b, wi, wo: _expert_glu(b, wi, wo, act_fn(cfg.act)), buf,
        p["wi"], p["wo"])
    out_buf = shard_act(out_buf, ("experts", "expert_cap", None))
    out = _replicated(_combine, 1, out_buf, dest, keep, gate)
    out = out.reshape(B, S, dm)

    if cfg.n_shared_experts:
        sgu = proj(h, p["swi"])
        out = out + matmul(act_fn(cfg.act)(sgu[:, :, 0]) * sgu[:, :, 1],
                           p["swo"])

    return x + shard_act(out, ("batch", "seq", "d_model"))


def aux_load_balance_loss(logits: torch.Tensor, eidx: torch.Tensor,
                          E: int) -> torch.Tensor:
    """Switch-style auxiliary loss. As in the reference, the LM loss
    (``transformer.loss_fn``) does not add it."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(eidx[:, 0].long(), E).float().mean(0)
    return E * torch.sum(me * ce)
