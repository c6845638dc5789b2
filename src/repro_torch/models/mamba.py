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
whole sequence up front, which changes no result) is not ported yet. Under
a mesh the inner activation and the block's output pass through
``shard_act`` at the reference's sites.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..dist.sharding import local_batch, shard_act
from ..kernels import opcount
from .common import (ModelConfig, ParamCtx, matmul, proj, rms_norm,
                     store)

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
        "norm": ctx.param("norm", (dm,), ("d_model",), init="zeros"),
        "in_proj": ctx.param("in_proj", (dm, 2, di),
                             ("d_model_fsdp", None, "d_ff")),
        "conv_w": ctx.param("conv_w", (ck, di), ("conv", "d_ff"),
                            scale=1.0 / math.sqrt(ck)),
        "conv_b": ctx.param("conv_b", (di,), ("d_ff",), init="zeros"),
        "x_proj": ctx.param("x_proj", (di, dtr + 2 * ds), ("d_ff", None)),
        "dt_proj": ctx.param("dt_proj", (dtr, di), (None, "d_ff"),
                             scale=dtr ** -0.5),
        "dt_bias": ctx.param("dt_bias", (di,), ("d_ff",), init="zeros"),
        # a deterministic constant, stored so A = -exp(A_log) stays negative
        "A_log": ctx.const("A_log", torch.log(a), ("d_ff", None)),
        "D": ctx.param("D", (di,), ("d_ff",), init="ones"),
        "out_proj": ctx.param("out_proj", (di, dm),
                              ("d_ff", "d_model_fsdp")),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _in_proj(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dce->bsce")``: ``[B, S, 2, di]``."""
    return proj(x, p["in_proj"])


def _ssm_inputs(p: dict, cfg: ModelConfig, xconv: torch.Tensor):
    """dt, B, C from the conv output ``xconv [B, S, di]``: (dA, dBx ``[B, S,
    di, ds]`` and C ``[B, S, ds]``, all fp32)."""
    di, ds, dtr, _ = _dims(cfg)
    xp = matmul(xconv, p["x_proj"])
    dt_r, Bm, Cm = torch.split(xp, [dtr, ds, ds], dim=-1)
    dt = _softplus(matmul(dt_r, p["dt_proj"])
                   + p["dt_bias"].to(xconv.dtype))
    A = -torch.exp(p["A_log"].float())                     # [di, ds]
    dA = torch.exp(dt.float()[..., None] * A)              # [B, S, di, ds]
    dBx = (dt * xconv).float()[..., None] * Bm.float()[..., None, :]
    return dA, dBx, Cm.float()


def _causal_conv(p: dict, x: torch.Tensor, ck: int) -> torch.Tensor:
    """Depthwise causal conv over ``[B, S, di]`` by shifted adds (k is
    tiny), summed in the reference's order; per rank on its batch shard
    under a mesh (``local_batch``)."""
    return local_batch(
        lambda xb, w, b: _causal_conv_local({"conv_w": w, "conv_b": b}, xb,
                                            ck),
        (x,), (p["conv_w"], p["conv_b"]))


def _causal_conv_local(p: dict, x: torch.Tensor, ck: int) -> torch.Tensor:
    w = p["conv_w"].to(x.dtype)
    S = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(ck):
        shift = ck - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xi * w[i]
    return F.silu(out + p["conv_b"].to(x.dtype))


_SCAN_LEAVES = ("x_proj", "dt_proj", "dt_bias", "A_log")


def _scan(p: dict, cfg: ModelConfig, xconv: torch.Tensor, chunk: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan over ``xconv [B, S, di]``, chunk by chunk, each
    chunk discretised in turn: (``y [B, S, di]`` fp32, the last state
    ``[B, di, ds]`` fp32). Per rank on its batch shard under a mesh
    (``dist.sharding.local_batch``)."""
    return local_batch(
        lambda xc, *w: _scan_local(dict(zip(_SCAN_LEAVES, w)), cfg, xc,
                                   chunk),
        (xconv,), tuple(p[k] for k in _SCAN_LEAVES), n_out=2)


def _scan_local(p: dict, cfg: ModelConfig, xconv: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, di = xconv.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    hstate = torch.zeros((B, di, cfg.mamba_d_state), dtype=torch.float32,
                         device=xconv.device)
    ys = []
    for c0 in opcount.trips(range(0, S, chunk)):
        dA, dBx, Cm = _ssm_inputs(p, cfg, xconv[:, c0:c0 + chunk])
        states = []
        for t in opcount.trips(range(dA.shape[1])):
            hstate = torch.addcmul(dBx[:, t], dA[:, t], hstate)
            states.append(hstate)
        states = opcount.fill(states, dA.shape[1])
        hs = torch.stack(states, dim=1)                    # [B, chunk, di, ds]
        ys.append((hs * Cm[:, :, None, :]).sum(-1))        # [B, chunk, di]
        del dA, dBx, hs, states
    ys = opcount.fill(ys, S // chunk)
    return (torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]), hstate.clone()


def mamba_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, chunk: int = 256,
              return_state: bool = False):
    """Chunked selective scan over ``x [B, S, d_model]`` (module doc)."""
    B, S, dm = x.shape
    di, ds, dtr, ck = _dims(cfg)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    xz = _in_proj(p, h)
    xin, z = xz[:, :, 0], xz[:, :, 1]
    xin = shard_act(xin, ("batch", "seq", "d_ff"))
    xconv = _causal_conv(p, xin, ck)

    y, hstate = _scan(p, cfg, xconv, chunk)
    y = y.to(x.dtype) + xconv * p["D"].to(x.dtype)
    y = y * F.silu(z)
    out = x + shard_act(matmul(y, p["out_proj"]),
                        ("batch", "seq", "d_model"))
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
    out = matmul(y, p["out_proj"])
    # the window is a new tensor: its shift cannot overlap the cache
    store(cache["conv"], window[:, 1:])
    store(cache["ssm"], hnew)
    return x + out[:, None], cache
