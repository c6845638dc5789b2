"""Flash attention, forward and backward: CUDA kernels + plain versions.

Softmax attention of queries ``q [B, Sq, H, D]`` over keys and values
``k, v [B, Skv, KV, D]``: query head h reads KV head ``h // (H // KV)``
(the reference's ``jnp.repeat``, never materialised), scores
``(q · k) * scale`` in fp32, causal masking with the diagonal at the end of
the keys (``offset = Skv - Sq``) to the finite ``NEG_INF``, an online
softmax over KV tiles with ``p`` rounded to V's dtype before the ``P · V``
product, and ``acc / max(l, 1e-30)`` in q's dtype.

Replaces the TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, ``_kernel``) with ``csrc/flash_attention.cu``; what
bounds it on the H100 and what its design does about that is written at
the top of that source: bf16 inputs run a FlashAttention-2 style kernel
on the tensor cores (``mma.sync`` bf16 with fp32 accumulators, bf16 K/V
tiles by ``cp.async``), fp32 inputs the first CUDA-core kernel; the entry
point picks by dtype (``_ENTRY``). The TPU kernel takes ``(BH, S, D)``
with KV already repeated; ``ops.attention`` keeps that contract on top of
this module, and ``models.layers.grouped_attention`` calls it in the
grouped ``[B, S, heads, D]`` layout, so neither needs a transpose.

:func:`flash_attention_torch` is the plain version: the chunked online
softmax of ``repro/models/layers.py`` (``grouped_attention``), which also
covers what the kernel does not — an explicit ``q_offset`` and a per-batch
``kv_len`` (the decode step's padded cache).

The backward (:func:`flash_attention_bwd`, ``csrc/flash_attention_bwd.cu``)
is port-only: the JAX package differentiates its attention in XLA
(``repro/models/layers.py``, ``grouped_attention``) and its Pallas forward
has no VJP. Given ``return_lse=True`` the forward also returns each row's
log-sum-exp ``[B, H, Sq]`` fp32, from which the backward's two launches
(dQ with the row sums Δ = rowsum(dO ∘ O), then dK/dV summed over each KV
head's query heads inside the block, no atomics) recompute the
probabilities. In bf16 at head dims 64 and 128 they run Hopper's
``wgmma`` on tiles loaded by TMA through maps over the callers' strides
(``_tma_ready`` copies a layout whose strides do not nest);
:func:`wgmma_check` runs the helpers they are built on alone.
:func:`flash_attention_bwd_torch` is its plain version: the closed-form
gradient of :func:`flash_attention_torch`.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Union

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128)       # the bf16 backward's wgmma kernels

_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_ENTRY = {torch.float32: "spira_flash_attention_f32",
          torch.bfloat16: "spira_flash_attention_bf16"}
_BWD_SIG = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_BWD_ENTRY = {torch.float32: "spira_flash_attention_bwd_f32",
              torch.bfloat16: "spira_flash_attention_bwd_bf16"}
_fns: dict = {}


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, scale: float,
                          q_offset: Union[int, torch.Tensor, None] = None,
                          kv_len: Optional[torch.Tensor] = None,
                          kv_chunk: Optional[int] = None,
                          on_scores: Optional[Callable] = None
                          ) -> torch.Tensor:
    """Plain version, any device. q ``[B, Sq, H, D]``, k/v ``[B, Skv, KV,
    D]``; returns ``[B, Sq, H, D]`` in q's dtype. ``q_offset`` is the
    absolute position of ``q[:, 0]`` (default ``Skv - Sq``, the kernel's
    end-aligned diagonal); ``kv_len`` ([B] or scalar) masks keys at or past
    it; ``kv_chunk`` is the reference's chunk (default: all keys in one;
    a chunk that does not divide Skv also means one). ``on_scores``, when
    given, maps each chunk's fp32 scores ``[B, KV, G, Sq, chunk]`` before
    the mask (the caller's sharding constraint)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    if q_offset is None:
        q_offset = Skv - Sq
    chunk = min(kv_chunk or Skv, Skv)
    if Skv % chunk:
        chunk = Skv
    # an int offset is added on the card: no host-to-device copy, which a
    # CUDA-graph capture of the decode step could not hold
    q_pos = torch.arange(Sq, device=dev) + q_offset
    qg = q.reshape(B, Sq, KV, G, D).float()
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=torch.float32, device=dev)
    for c0 in range(0, Skv, chunk):
        ks = k[:, c0:c0 + chunk].float()
        vs = v[:, c0:c0 + chunk]
        s = torch.einsum("bqngd,bknd->bngqk", qg, ks) * scale
        if on_scores is not None:
            s = on_scores(s)
        kpos = c0 + torch.arange(chunk, device=dev)
        mask = torch.ones((B, Sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= (q_pos[:, None] >= kpos[None, :])[None]
        if kv_len is not None:
            kl = torch.as_tensor(kv_len, device=dev).expand(B)
            mask &= kpos[None, None, :] < kl[:, None, None]
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bngqk,bknd->bngqd", p.to(v.dtype).float(), vs.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel's 16-byte row loads can read it in
    place (D contiguous, every other stride a multiple of 16 bytes, the
    base 16-byte aligned), else a contiguous copy."""
    per = 16 // t.element_size()
    if (t.stride(-1) == 1 and all(s % per == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its (head, seq, batch) strides nest (each at least
    the extent times the stride of the dimension inside it, dimensions of
    extent 1 aside), as the bf16 backward's TMA maps over (D, head, seq,
    batch) want; else a contiguous copy."""
    inner = t.shape[3]
    for dim in (2, 1, 0):
        if t.shape[dim] > 1:
            if t.stride(dim) < inner:
                return t.clone(memory_format=torch.contiguous_format)
            inner = t.stride(dim) * t.shape[dim]
    return t


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           what: str) -> None:
    """Raise on what the kernels do not take (the forward's contract)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; got a tensor on "
                         f"{q.device}")
    dt = q.dtype
    if dt not in _ENTRY or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"q/k/v must all be fp32 or bf16, got {q.dtype}/"
                        f"{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B, Sq, H, D] and k, v [B, Skv, KV, D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "match (batch, head dim, or H a multiple of KV)")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel is compiled for "
                         f"{HEAD_DIMS}")
    if Skv == 0:
        raise ValueError(f"{what} needs at least one key")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must share a device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, scale: float, return_lse: bool = False):
    """Launch the CUDA kernel on CUDA tensors (a CPU tensor raises). q
    ``[B, Sq, H, D]``, k/v ``[B, Skv, KV, D]``, one dtype (fp32 or bf16),
    D in ``HEAD_DIMS``, H a multiple of KV; read through their strides.
    Returns a contiguous ``[B, Sq, H, D]`` in that dtype, and with
    ``return_lse`` also each row's log-sum-exp, contiguous ``[B, H, Sq]``
    fp32 (the backward's input)."""
    _check(q, k, v, "flash_attention")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    dt = q.dtype
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((B, Sq, H, D), dtype=dt, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    fn = _fns.get(dt)
    if fn is None:
        fn = _fns[dt] = _build.function(_ENTRY[dt], _SIG)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), B, Sq, Skv, H, KV, D,
             ctypes.addressof(strides), int(causal), float(scale), stream)
    flash_attention.launches += 1
    _build.check(err, "flash_attention")
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool, scale: float):
    """Launch the backward kernels (dQ, then dK/dV) on CUDA tensors (a CPU
    tensor raises): the gradients ``(dq [B, Sq, H, D], dk, dv [B, Skv, KV,
    D])``, contiguous, in q's dtype, of :func:`flash_attention` at ``(q, k,
    v)`` given its output ``out``, the output's gradient ``dout`` and the
    forward's ``lse``. The forward's contract, and ``causal`` needs
    ``Sq <= Skv`` (every row sees a key). Counts one launch per call."""
    _check(q, k, v, "flash_attention_bwd")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    dt = q.dtype
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != dt or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"lse must be fp32 [B, H, Sq] = {(B, H, Sq)} on "
                         f"{q.device}; got {tuple(lse.shape)} {lse.dtype}")
    if causal and Sq > Skv:
        raise ValueError(f"causal backward needs Sq <= Skv (got {Sq} > "
                         f"{Skv}): a row with no visible key")
    q, k, v, out, dout = (_aligned(t) for t in (q, k, v, out, dout))
    if dt == torch.bfloat16 and D in WGMMA_HEAD_DIMS:
        q, k, v, dout = (_tma_ready(t) for t in (q, k, v, dout))
    lse = lse.contiguous()
    dq = torch.empty((B, Sq, H, D), dtype=dt, device=q.device)
    dk = torch.empty((B, Skv, KV, D), dtype=dt, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 15)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3],
                                    *dout.stride()[:3])
    key = ("bwd", dt)
    fn = _fns.get(key)
    if fn is None:
        fn = _fns[key] = _build.function(_BWD_ENTRY[dt], _BWD_SIG)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H, KV,
             D, ctypes.addressof(strides), int(causal), float(scale), stream)
    flash_attention_bwd.launches += 1
    _build.check(err, "flash_attention_bwd")
    return dq, dk, dv


flash_attention_bwd.launches = 0


def flash_attention_bwd_torch(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor, *, causal: bool,
                              scale: float):
    """Plain version of :func:`flash_attention_bwd`, any device: the
    closed-form gradient of :func:`flash_attention_torch` (end-aligned
    causal diagonal, no ``kv_len``) in fp32, or in float64 for float64
    inputs (the float64 gate of ``chip_smoke.py``). P is recomputed from
    the scores' log-sum-exp and rounded to v's dtype for dV, as the forward
    rounds it for P·V; Δ = rowsum(dO ∘ O) from the forward's output.
    Returns ``(dq, dk, dv)`` in q's dtype."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(B, Sq, KV, G, D).to(ct)
    dog = dout.reshape(B, Sq, KV, G, D).to(ct)
    og = out.reshape(B, Sq, KV, G, D).to(ct)
    ks, vs = k.to(ct), v.to(ct)
    s = torch.einsum("bqngd,bknd->bngqk", qg, ks) * scale
    if causal:
        q_pos = torch.arange(Sq, device=q.device) + (Skv - Sq)
        mask = q_pos[:, None] >= torch.arange(Skv, device=q.device)[None]
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    if causal:
        p = torch.where(mask, p, 0.0)
    del s
    dv = torch.einsum("bngqk,bqngd->bknd", p.to(v.dtype).to(ct), dog)
    dp = torch.einsum("bqngd,bknd->bngqk", dog, vs)
    delta = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]   # [b,n,g,q,1]
    ds = p * (dp - delta)
    del dp, p
    dq = torch.einsum("bngqk,bknd->bqngd", ds, ks) * scale
    dk = torch.einsum("bngqk,bqngd->bknd", ds, qg) * scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def wgmma_check(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor):
    """The check of the wgmma helpers that the bf16 backward is built on
    (``csrc/flash_attention_bwd.cu``, ``spira_wgmma_check``): a, b, v bf16
    ``[64, D]``, D in ``WGMMA_HEAD_DIMS``; returns ``x = a · bᵀ`` fp32
    ``[64, 64]`` (both operands from shared memory, as S and dP) and
    ``y = bf16(x) · v`` fp32 ``[64, D]`` (A from registers, v MN-major, as
    dQ, dK and dV). On CUDA tensors it launches the kernel; on CPU tensors
    it runs :func:`wgmma_check_torch`, its plain version."""
    D = a.shape[1]
    for t in (a, b, v):
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != (64, D)
                or D not in WGMMA_HEAD_DIMS or t.device != a.device):
            raise ValueError(f"wgmma_check takes bf16 [64, D] tensors on one "
                             f"device, D in {WGMMA_HEAD_DIMS}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if a.device.type != "cuda":
        return wgmma_check_torch(a, b, v)
    a, b, v = (t.contiguous() for t in (a, b, v))
    x = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    y = torch.empty((64, D), dtype=torch.float32, device=a.device)
    fn = _fns.get("wgmma_check")
    if fn is None:
        fn = _fns["wgmma_check"] = _build.function(
            "spira_wgmma_check", [ctypes.c_void_p] * 5 + [ctypes.c_int,
                                                          ctypes.c_void_p])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), v.data_ptr(), x.data_ptr(),
             y.data_ptr(), D, stream)
    _build.check(err, "wgmma_check")
    return x, y


def wgmma_check_torch(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor):
    """Plain version of :func:`wgmma_check`, any device."""
    x = a.float() @ b.float().T
    return x, x.to(torch.bfloat16).float() @ v.float()


class FlashAttentionFn(torch.autograd.Function):
    """Causal flash attention under autograd on the card (scale 1, the
    caller's q already scaled): the forward kernel with the row
    log-sum-exp saved, the backward kernels for the gradients. The launches
    go through ``launch_fwd`` / ``launch_bwd`` as given, so a caller's
    module binding (where ``chip_smoke.Recorder`` looks) decides what
    runs."""

    @staticmethod
    def forward(ctx, q, k, v, launch_fwd, launch_bwd):
        out, lse = launch_fwd(q, k, v, causal=True, scale=1.0,
                              return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.launch_bwd = launch_bwd
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ctx.launch_bwd(q, k, v, out, dout, lse, causal=True,
                                    scale=1.0)
        return dq, dk, dv, None, None
