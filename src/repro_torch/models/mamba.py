"""Mamba (selective SSM) block, for the Jamba hybrid architecture.

The port of ``repro/models/mamba.py``: input-dependent dt/B/C, diagonal A,
a causal depthwise conv stem and a gated output (S6). The full-sequence
pass keeps the reference's chunking (``chunk = min(256, S)``, the whole
sequence when S is not a multiple of it) and discretises each chunk inside
the scan, so the ``[B, S, d_inner, d_state]`` tensors of the whole
sequence never exist. Within a chunk the recurrence ``h_t = a_t h_{t-1} +
b_t`` runs as a loop over the chunk's steps (one fused multiply-add per
step, the states stacked once per chunk, which autograd differentiates as
it is): PyTorch has no associative scan, and
the reference's parallel scan differs from it only in rounding. Decode is
O(1) per token with the (conv window, ssm state) cache written in place.

The reference's ``REPRO_MAMBA_PREMAT`` switch (its A/B of discretising the
whole sequence up front, which changes no result) is not ported.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, ParamCtx, rms_norm

__all__ = ["mamba_init", "mamba_fwd", "mamba_prefill", "mamba_init_cache",
           "mamba_step"]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    di = cfg.mamba_expand * cfg.d_model
    ds = cfg.mamba_d_state
    dtr = max(1, math.ceil(cfg.d_model / 16))
    return di, ds, dtr, cfg.mamba_conv


def mamba_init(ctx: ParamCtx, cfg: ModelConfig) -> dict:
    dm = cfg.d_model
    di, ds, dtr, ck = _dims(cfg)
    a = torch.arange(1, ds + 1, dtype=torch.float32)[None].repeat(di, 1)
    return {
        "norm": ctx.param((dm,), init="zeros"),
        "in_proj": ctx.param((dm, 2, di)),
        "conv_w": ctx.param((ck, di), scale=1.0 / math.sqrt(ck)),
        "conv_b": ctx.param((di,), init="zeros"),
        "x_proj": ctx.param((di, dtr + 2 * ds)),
        "dt_proj": ctx.param((dtr, di), scale=dtr ** -0.5),
        "dt_bias": ctx.param((di,), init="zeros"),
        # a deterministic constant, stored so A = -exp(A_log) stays negative
        "A_log": ctx.const(torch.log(a)),
        "D": ctx.param((di,), init="ones"),
        "out_proj": ctx.param((di, dm)),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _in_proj(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dce->bsce")``: ``[B, S, 2, di]``."""
    w = p["in_proj"].to(x.dtype)
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _ssm_inputs(p: dict, cfg: ModelConfig, xconv: torch.Tensor):
    """dt, B, C from the conv output ``xconv [B, S, di]``: (dA, dBx ``[B, S,
    di, ds]`` and C ``[B, S, ds]``, all fp32)."""
    di, ds, dtr, _ = _dims(cfg)
    proj = xconv @ p["x_proj"].to(xconv.dtype)
    dt_r, Bm, Cm = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = _softplus(dt_r @ p["dt_proj"].to(xconv.dtype)
                   + p["dt_bias"].to(xconv.dtype))
    A = -torch.exp(p["A_log"].float())                     # [di, ds]
    dA = torch.exp(dt.float()[..., None] * A)              # [B, S, di, ds]
    dBx = (dt * xconv).float()[..., None] * Bm.float()[..., None, :]
    return dA, dBx, Cm.float()


def _causal_conv(p: dict, x: torch.Tensor, ck: int) -> torch.Tensor:
    """Depthwise causal conv over ``[B, S, di]`` by shifted adds (k is
    tiny), summed in the reference's order."""
    w = p["conv_w"].to(x.dtype)
    S = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(ck):
        shift = ck - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xi * w[i]
    return F.silu(out + p["conv_b"].to(x.dtype))


def _scan(p: dict, cfg: ModelConfig, xconv: torch.Tensor, chunk: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan over ``xconv [B, S, di]``, chunk by chunk, each
    chunk discretised in turn: (``y [B, S, di]`` fp32, the last state
    ``[B, di, ds]`` fp32)."""
    B, S, di = xconv.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    hstate = torch.zeros((B, di, cfg.mamba_d_state), dtype=torch.float32,
                         device=xconv.device)
    ys = []
    for c0 in range(0, S, chunk):
        dA, dBx, Cm = _ssm_inputs(p, cfg, xconv[:, c0:c0 + chunk])
        states = []
        for t in range(dA.shape[1]):
            hstate = torch.addcmul(dBx[:, t], dA[:, t], hstate)
            states.append(hstate)
        hs = torch.stack(states, dim=1)                    # [B, chunk, di, ds]
        ys.append((hs * Cm[:, :, None, :]).sum(-1))        # [B, chunk, di]
        del dA, dBx, hs, states
    return (torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]), hstate.clone()


def mamba_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, chunk: int = 256,
              return_state: bool = False):
    """Chunked selective scan over ``x [B, S, d_model]`` (module doc)."""
    B, S, dm = x.shape
    di, ds, dtr, ck = _dims(cfg)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    xz = _in_proj(p, h)
    xin, z = xz[:, :, 0], xz[:, :, 1]
    xconv = _causal_conv(p, xin, ck)

    y, hstate = _scan(p, cfg, xconv, chunk)
    y = y.to(x.dtype) + xconv * p["D"].to(x.dtype)
    y = y * F.silu(z)
    out = x + y @ p["out_proj"].to(x.dtype)
    if return_state:
        return out, {"conv": xin[:, S - (ck - 1):], "ssm": hstate}
    return out


def mamba_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor):
    return mamba_fwd(p, cfg, x, return_state=True)


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype,
                     device="cuda") -> dict:
    di, ds, _, ck = _dims(cfg)
    return {"conv": torch.zeros((batch, ck - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, ds), dtype=torch.float32,
                               device=device)}


def mamba_step(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               pos) -> Tuple[torch.Tensor, dict]:
    """Decode one token ``x [B, 1, d_model]``: O(1) state update, the
    cache's conv window and ssm state written in place."""
    di, ds, dtr, ck = _dims(cfg)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    xz = _in_proj(p, h)
    xin, z = xz[:, 0, 0], xz[:, 0, 1]                      # [B, di]
    window = torch.cat([cache["conv"], xin[:, None]], dim=1)  # [B, ck, di]
    w = p["conv_w"].to(x.dtype)
    xconv = F.silu((window * w[None]).sum(1) + p["conv_b"].to(x.dtype))
    dA, dBx, Cm = _ssm_inputs(p, cfg, xconv[:, None])
    hnew = dA[:, 0] * cache["ssm"] + dBx[:, 0]             # [B, di, ds]
    y = (hnew * Cm[:, 0, None, :]).sum(-1).to(x.dtype)
    y = y + xconv * p["D"].to(x.dtype)
    y = y * F.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    # the window is a new tensor: its shift cannot overlap the cache
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(hnew)
    return x + out[:, None], cache
