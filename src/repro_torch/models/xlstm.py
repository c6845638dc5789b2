"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelisable)
and sLSTM (scalar memory, sequential) with stabilised exponential gating.

The port of ``repro/models/xlstm.py``. mLSTM's full-sequence pass is the
reference's chunkwise-parallel form (quadratic only within a chunk,
recurrent across chunks, a log-space stabiliser ``m``), with its chunking
(``chunk = min(256, S)``, the whole sequence when S is not a multiple of
it). sLSTM is sequential by nature: a loop over time, its outputs stacked
once (no in-place writes, so autograd differentiates the loop). Both
decode one token in O(1), the cache's leaves written in place. Under a
mesh the inner activation and the blocks' outputs pass through
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

__all__ = ["mlstm_init", "mlstm_fwd", "mlstm_prefill", "mlstm_init_cache",
           "mlstm_step", "slstm_init", "slstm_fwd", "slstm_prefill",
           "slstm_init_cache", "slstm_step"]

NEG = -1e30          # the stabiliser's start: no history


def _mdims(cfg: ModelConfig) -> Tuple[int, int]:
    di = int(cfg.lstm_proj_factor * cfg.d_model)
    dh = di // cfg.n_heads
    return di, dh


def _glu_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dce->bsce")`` as one matmul."""
    return proj(x, w)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(ctx: ParamCtx, cfg: ModelConfig) -> dict:
    dm = cfg.d_model
    di, dh = _mdims(cfg)
    H = cfg.n_heads
    return {
        "norm": ctx.param("norm", (dm,), ("d_model",), init="zeros"),
        "up": ctx.param("up", (dm, 2, di), ("d_model_fsdp", None, "d_ff")),
        "wq": ctx.param("wq", (di, H, dh), ("d_ff", "heads", None)),
        "wk": ctx.param("wk", (di, H, dh), ("d_ff", "heads", None)),
        "wv": ctx.param("wv", (di, H, dh), ("d_ff", "heads", None)),
        "wi": ctx.param("wi", (di, H), ("d_ff", "heads"), scale=0.02),
        "bi": ctx.param("bi", (H,), ("heads",), init="zeros"),
        "wf": ctx.param("wf", (di, H), ("d_ff", "heads"), scale=0.02),
        "bf": ctx.param("bf", (H,), ("heads",), init="ones"),
        "og": ctx.param("og", (di, di), ("d_ff", "d_ff")),
        "down": ctx.param("down", (di, dm), ("d_ff", "d_model_fsdp")),
    }


def _mlstm_qkvgates(p: dict, cfg: ModelConfig, xin: torch.Tensor):
    """q, k (scaled by 1/√dh), v ``[B, S, H, dh]``; the input and forget
    gates' pre-activations ``[B, S, H]`` in fp32 (the callers take the
    forget gate's log-sigmoid: per rank, under a mesh)."""
    q = _glu_in(xin, p["wq"])
    k = _glu_in(xin, p["wk"]) / math.sqrt(q.shape[-1])
    v = _glu_in(xin, p["wv"])
    igate = (matmul(xin, p["wi"]) + p["bi"].to(xin.dtype)).float()
    fgate = (matmul(xin, p["wf"]) + p["bf"].to(xin.dtype)).float()
    return q, k, v, igate, fgate


def _mlstm_out(p: dict, hseq: torch.Tensor, xin: torch.Tensor,
               z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The output gate, the z gate and the down projection, plus the
    residual."""
    hseq = hseq * torch.sigmoid(matmul(xin, p["og"]))
    hseq = hseq * F.silu(z)
    return x + matmul(hseq, p["down"])


def _mlstm_chunk(carry, qb, kb, vb, ib, fb):
    """One chunk of the chunkwise-parallel form: the reference's
    ``scan_chunk``, time-major ``[chunk, B, H, ...]`` inputs."""
    C, nrm, m = carry          # [B,H,dh,dh], [B,H,dh], [B,H]
    L = qb.shape[0]
    fcum = torch.cumsum(fb, dim=0)                     # Σ log f within chunk
    ftot = fcum[-1]
    lw_state = fcum + m[None]                          # [chunk,B,H]
    lw_src = ib - fcum                                 # source log-weight base
    m_src = torch.cummax(lw_src, dim=0).values + fcum
    m_new_t = torch.maximum(lw_state, m_src)           # running max per t
    lsm = lw_src[None, :] + fcum[:, None]              # [t, s, B, H]
    tril = torch.ones((L, L), dtype=torch.bool, device=qb.device).tril()
    w = torch.where(tril[:, :, None, None],
                    torch.exp(lsm - m_new_t[:, None]),
                    torch.zeros((), device=qb.device))
    qs, ks, vs = qb.float(), kb.float(), vb.float()
    att = torch.einsum("tbhd,sbhd->tsbh", qs, ks)
    num_intra = torch.einsum("tsbh,sbhe->tbhe", w * att, vs)
    den_intra = torch.einsum("tsbh,sbhd->tbhd", w, ks)
    den_intra = torch.einsum("tbhd,tbhd->tbh", qs, den_intra)
    dec = torch.exp(lw_state - m_new_t)                # [chunk,B,H]
    num_state = torch.einsum("tbhd,bhde->tbhe", qs, C) * dec[..., None]
    den_state = torch.einsum("tbhd,bhd->tbh", qs, nrm) * dec
    num = num_intra + num_state
    den = den_intra + den_state
    hout = num / torch.maximum(den.abs(), torch.exp(-m_new_t))[..., None]
    # chunk-end state
    m_end = torch.maximum(ftot + m, torch.amax(lw_src + ftot, dim=0))
    wsrc = torch.exp(lw_src + ftot - m_end[None])      # [chunk,B,H]
    decay = torch.exp(ftot + m - m_end)
    C_new = decay[..., None, None] * C + torch.einsum(
        "sbh,sbhd,sbhe->bhde", wsrc, ks, vs)
    n_new = decay[..., None] * nrm + torch.einsum("sbh,sbhd->bhd", wsrc, ks)
    return (C_new, n_new, m_end), hout


def mlstm_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, chunk: int = 256,
              return_state: bool = False):
    """Chunkwise-parallel mLSTM over ``x [B, S, d_model]``."""
    B, S, dm = x.shape
    di, dh = _mdims(cfg)
    H = cfg.n_heads
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    ug = _glu_in(h, p["up"])
    xin, z = ug[:, :, 0], ug[:, :, 1]
    xin = shard_act(xin, ("batch", "seq", "d_ff"))
    q, k, v, igate, fgate = _mlstm_qkvgates(p, cfg, xin)

    hseq, C_f, n_f, m_f = local_batch(
        lambda *t: _mlstm_scan(*t, chunk=chunk), (q, k, v, igate, fgate),
        n_out=4)
    hseq = hseq.reshape(B, S, di).to(x.dtype)
    out = shard_act(_mlstm_out(p, hseq, xin, z, x),
                    ("batch", "seq", "d_model"))
    if return_state:
        return out, {"C": C_f, "n": n_f, "m": m_f}
    return out


def _mlstm_scan(q, k, v, igate, fgate, *, chunk: int):
    """The chunks in turn over ``q, k, v [B, S, H, dh]`` and the gates
    ``[B, S, H]``: (the outputs ``[B, S, H, dh]`` fp32, and the final C, n,
    m). Per rank on its batch shard under a mesh (``local_batch``)."""
    B, S, H, dh = q.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    tm = lambda t: t.transpose(0, 1)                   # noqa: E731 time-major
    logf = F.logsigmoid(fgate)
    qt, kt, vt, it, ft = (tm(t) for t in (q, k, v, igate, logf))
    dev = q.device
    carry = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev),
             torch.zeros((B, H, dh), dtype=torch.float32, device=dev),
             torch.full((B, H), NEG, dtype=torch.float32, device=dev))
    hs = []
    for c0 in opcount.trips(range(0, S, chunk)):
        sl = slice(c0, c0 + chunk)
        carry, hout = _mlstm_chunk(carry, qt[sl], kt[sl], vt[sl], it[sl],
                                   ft[sl])
        hs.append(hout)
    hs = opcount.fill(hs, S // chunk)
    hseq = torch.cat(hs, dim=0) if len(hs) > 1 else hs[0]   # [S, B, H, dh]
    return (hseq.transpose(0, 1), *carry)


def mlstm_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor):
    return mlstm_fwd(p, cfg, x, return_state=True)


def mlstm_init_cache(cfg: ModelConfig, batch: int, dtype,
                     device="cuda") -> dict:
    di, dh = _mdims(cfg)
    H = cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dh, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H), NEG, **f32)}


def mlstm_step(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               pos) -> Tuple[torch.Tensor, dict]:
    """Decode one token ``x [B, 1, d_model]``, the cache written in
    place."""
    B = x.shape[0]
    di, dh = _mdims(cfg)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    ug = _glu_in(h, p["up"])
    xin, z = ug[:, 0, 0], ug[:, 0, 1]                      # [B, di]
    q, k, v, igate, fgate = _mlstm_qkvgates(p, cfg, xin[:, None])
    logf = F.logsigmoid(fgate)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                    # [B,H,dh]
    i0, f0 = igate[:, 0], logf[:, 0]                       # [B,H]
    C, nrm, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(f0 + m, i0)
    a = torch.exp(f0 + m - m_new)[..., None]
    b = torch.exp(i0 - m_new)[..., None]
    kf, vf, qf = k.float(), v.float(), q.float()
    C_new = a[..., None] * C + b[..., None] * kf[..., :, None] \
        * vf[..., None, :]
    n_new = a * nrm + b * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C_new)
    den = torch.einsum("bhd,bhd->bh", qf, n_new)
    hout = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    hvec = hout.reshape(B, di).to(x.dtype)
    out = _mlstm_out(p, hvec, xin, z, x[:, 0])
    store(C, C_new)
    store(nrm, n_new)
    store(m, m_new)
    return out[:, None], cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(ctx: ParamCtx, cfg: ModelConfig) -> dict:
    dm = cfg.d_model
    return {
        "norm": ctx.param("norm", (dm,), ("d_model",), init="zeros"),
        "wx": ctx.param("wx", (dm, 4, dm), ("d_model_fsdp", None, "d_ff")),
        "wr": ctx.param("wr", (dm, 4, dm), ("d_ff", None, "d_ff"),
                        scale=0.02),
        "b": ctx.param("b", (4, dm), (None, "d_ff"), init="zeros"),
        "down": ctx.param("down", (dm, dm), ("d_ff", "d_model_fsdp")),
    }


def _slstm_cell(p: dict, xt: torch.Tensor, state):
    """One sLSTM step. ``xt [B, 4, dm]`` (precomputed ``Wx x_t``); state
    (c, n, h, m)."""
    c, n, hprev, m = state
    g = xt + _glu_in(hprev, p["wr"]) + p["b"].to(hprev.dtype)
    i, f, zg, o = (g[:, j].float() for j in range(4))
    logf = F.logsigmoid(f)
    m_new = torch.maximum(logf + m, i)
    ie = torch.exp(i - m_new)
    fe = torch.exp(logf + m - m_new)
    c_new = fe * c + ie * torch.tanh(zg)
    n_new = fe * n + ie
    h_new = (torch.sigmoid(o) * c_new
             / n_new.clamp(min=1e-6)).to(hprev.dtype)
    return c_new, n_new, h_new, m_new


def slstm_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor,
              return_state: bool = False):
    B, S, dm = x.shape
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    xg = _glu_in(h, p["wx"])                               # [B,S,4,dm]
    hs, c_f, n_f, h_f, m_f = local_batch(
        lambda xg_, wr, b: _slstm_scan({"wr": wr, "b": b}, xg_), (xg,),
        (p["wr"], p["b"]), n_out=5)
    out = x + shard_act(matmul(hs, p["down"]), ("batch", "seq", "d_model"))
    if return_state:
        return out, {"c": c_f, "n": n_f, "h": h_f, "m": m_f}
    return out


def _slstm_scan(p: dict, xg: torch.Tensor):
    """The sLSTM steps in turn over ``xg [B, S, 4, dm]``: (the outputs ``[B,
    S, dm]`` and the final c, n, h, m). Per rank on its batch shard under
    a mesh (``local_batch``)."""
    B, S, _, dm = xg.shape
    f32 = dict(dtype=torch.float32, device=xg.device)
    state = (torch.zeros((B, dm), **f32), torch.zeros((B, dm), **f32),
             torch.zeros((B, dm), dtype=xg.dtype, device=xg.device),
             torch.full((B, dm), NEG, **f32))
    hs = []
    for t in opcount.trips(range(S)):
        state = _slstm_cell(p, xg[:, t], state)
        hs.append(state[2])
    hs = opcount.fill(hs, S)
    return (torch.stack(hs, dim=1), *state)


def slstm_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor):
    return slstm_fwd(p, cfg, x, return_state=True)


def slstm_init_cache(cfg: ModelConfig, batch: int, dtype,
                     device="cuda") -> dict:
    dm = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, dm), **f32),
            "n": torch.zeros((batch, dm), **f32),
            "h": torch.zeros((batch, dm), dtype=dtype, device=device),
            "m": torch.full((batch, dm), NEG, **f32)}


def slstm_step(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               pos) -> Tuple[torch.Tensor, dict]:
    """Decode one token ``x [B, 1, d_model]``, the cache written in
    place."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    xg = _glu_in(h, p["wx"])[:, 0]
    new = _slstm_cell(p, xg, (cache["c"], cache["n"], cache["h"],
                              cache["m"]))
    out = matmul(new[2], p["down"])
    for name, t in zip(("c", "n", "h", "m"), new):
        store(cache[name], t)
    return x + out[:, None], cache
