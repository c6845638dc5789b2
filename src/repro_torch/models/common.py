"""LM substrate: configs, parameter init and the shared layer math.

The port of ``repro/models/common.py``. Parameters are plain nested dicts
of tensors, in the JAX package's layouts, so that a JAX parameter tree
converts leaf for leaf (``convert.lm_params_from_jax``). The casts of the
reference are kept exactly: :func:`rms_norm` normalises in fp32, casts to
x's dtype and multiplies by ``1 + g`` in x's dtype; :func:`rope` builds
fp32 angles and casts cos/sin to x's dtype before the products; ``gelu``
is the tanh approximation (``jax.nn.gelu``'s default).

Every parameter is created through ``ParamCtx.param`` with the
reference's *logical axis names*, recorded in the ctx's ``axes`` table
(slash-joined tree path → axes, a stacked leaf's with a leading
``"layers"``), which ``transformer.init_params`` and ``abstract_params``
return beside the tree; logical→mesh resolution lives in
``dist/sharding.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Literal, Optional, Tuple

import torch
import torch.nn.functional as F

from ..dist.sharding import is_dtensor, local_linear, whole

BlockKind = Literal["attn", "mamba", "mlstm", "slstm"]
FfnKind = Literal["dense", "moe", "none"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class SuperBlock:
    """A repeated group of sub-layers: ``repeat`` instances of ``blocks``."""

    blocks: Tuple[Tuple[BlockKind, FfnKind], ...]
    repeat: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    superblocks: Tuple[SuperBlock, ...]
    act: Literal["silu", "gelu"] = "silu"          # GLU gate activation
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # Mamba
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4
    # xLSTM
    lstm_proj_factor: float = 2.0
    # misc
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embedding_inputs: bool = False   # VLM/audio stubs: inputs are embeddings
    dtype: str = "bfloat16"
    # long-context behaviour (which shapes are legal; see configs/)
    subquadratic: bool = False

    @property
    def n_layers(self) -> int:
        return sum(sb.repeat * len(sb.blocks) for sb in self.superblocks)

    @property
    def param_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def dense_lm(name: str, n_layers: int, d_model: int, n_heads: int, n_kv: int,
             d_ff: int, vocab: int, head_dim: Optional[int] = None,
             act: str = "silu", **kw) -> ModelConfig:
    return ModelConfig(
        name=name, d_model=d_model, n_heads=n_heads, n_kv=n_kv,
        head_dim=head_dim or d_model // n_heads, d_ff=d_ff, vocab=vocab,
        superblocks=(SuperBlock(blocks=(("attn", "dense"),), repeat=n_layers),),
        act=act, **kw)


def moe_lm(name: str, n_layers: int, d_model: int, n_heads: int, n_kv: int,
           d_ff_expert: int, vocab: int, n_experts: int, top_k: int,
           head_dim: Optional[int] = None, **kw) -> ModelConfig:
    return ModelConfig(
        name=name, d_model=d_model, n_heads=n_heads, n_kv=n_kv,
        head_dim=head_dim or d_model // n_heads, d_ff=0, vocab=vocab,
        superblocks=(SuperBlock(blocks=(("attn", "moe"),), repeat=n_layers),),
        n_experts=n_experts, top_k=top_k, d_ff_expert=d_ff_expert, **kw)


# ---------------------------------------------------------------------------
# parameter creation
# ---------------------------------------------------------------------------

DRAW_LIMIT = 1 << 28     # fp32 elements drawn at once (1 GiB)


def _stacked(stack: int, shape) -> Tuple[int, ...]:
    return ((stack,) if stack else ()) + tuple(shape)


class _AxesCtx:
    """The logical-axes bookkeeping of the reference's ``ParamCtx``: a
    scope path, and ``axes[path] = logical`` for every leaf made (with a
    leading ``"layers"`` when ``stack`` > 0). Ctxs that build one tree
    share one ``axes`` dict."""

    def __init__(self, stack: int = 0, axes: Optional[dict] = None,
                 prefix: Tuple[str, ...] = ()):
        self.stack = stack
        self.axes: Dict[str, Tuple[Optional[str], ...]] = (
            {} if axes is None else axes)
        self._path = list(prefix)

    @contextlib.contextmanager
    def scope(self, name: str):
        self._path.append(name)
        try:
            yield
        finally:
            self._path.pop()

    def _record(self, name: str, shape, logical) -> Tuple[int, ...]:
        if len(shape) != len(logical):
            raise ValueError(f"{name}: shape {tuple(shape)} with axes "
                             f"{logical}")
        self.axes["/".join(self._path + [name])] = (
            (("layers",) if self.stack else ()) + tuple(logical))
        return _stacked(self.stack, shape)


class ParamCtx(_AxesCtx):
    """Draws parameters from an explicit ``torch.Generator`` with the
    reference's distributions: normal · (1/√fan_in), fan_in = ``shape[-2]``
    (``shape[-1]`` for vectors), or an explicit ``scale``; ``"zeros"`` /
    ``"ones"`` as the reference's inits. ``stack`` > 0 prepends a layer
    axis of that length (one draw per layer, so the fp32 draw never holds
    more than one layer; a layer of more than ``DRAW_LIMIT`` elements, such
    as a stack of expert weights, is drawn in slices of at most that many
    along its first axis). The numbers are not ``jax.random``'s: parity
    tests convert JAX parameters instead."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device, stack: int = 0, axes: Optional[dict] = None,
                 prefix: Tuple[str, ...] = ()):
        super().__init__(stack, axes, prefix)
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)

    def param(self, name: str, shape: Tuple[int, ...],
              logical: Tuple[Optional[str], ...], init: str = "normal",
              scale: Optional[float] = None) -> torch.Tensor:
        full = self._record(name, shape, logical)
        if init in ("zeros", "ones"):
            fill = torch.zeros if init == "zeros" else torch.ones
            return fill(full, dtype=self.dtype, device=self.device)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        out = torch.empty(full, dtype=self.dtype, device=self.device)
        for part in (out if self.stack else (out,)):
            rows = max(1, DRAW_LIMIT // max(1, part[0].numel()))
            for piece in (part.split(rows) if part.numel() > DRAW_LIMIT
                          else (part,)):
                piece.copy_(torch.randn(tuple(piece.shape),
                                        generator=self.generator,
                                        dtype=torch.float32,
                                        device=self.device) * s)
        return out

    def const(self, name: str, value: torch.Tensor,
              logical: Tuple[Optional[str], ...]) -> torch.Tensor:
        """A deterministic leaf (the same in every layer), in the ctx's
        dtype on its device."""
        self._record(name, value.shape, logical)
        v = value.to(device=self.device, dtype=self.dtype)
        return v.expand(_stacked(self.stack, v.shape)).clone()


class ShapeCtx(_AxesCtx):
    """:class:`ParamCtx`'s interface returning each leaf's shape instead of
    drawing it: the parameter tree's shapes (and axes) from the init code
    itself."""

    def param(self, name: str, shape, logical, init: str = "normal",
              scale=None) -> Tuple[int, ...]:
        return self._record(name, shape, logical)

    def const(self, name: str, value: torch.Tensor, logical
              ) -> Tuple[int, ...]:
        return self._record(name, value.shape, logical)


# ---------------------------------------------------------------------------
# shared math
# ---------------------------------------------------------------------------

def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def _glu_local(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).unflatten(
        -1, w.shape[1:])


def store(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; a DTensor ``src`` into a whole (plain) ``dst`` —
    a serving engine's cache under a sharded model — as its whole
    tensor."""
    dst.copy_(src if is_dtensor(dst) else whole(src))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in x's dtype (w cast to it); per rank on DTensors
    (``dist.sharding.local_linear``)."""
    return local_linear(_matmul, x, w)


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,d...->......")``: x ``[..., d]`` against w ``[d, *o]``
    as one matmul over w's trailing dims flattened, then unflattened; per
    rank on DTensors."""
    return local_linear(_glu_local, x, w)


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + g.to(x.dtype))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, D], positions: [..., S]."""
    d = x.shape[-1]
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * freqs                 # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in fp32. logits [..., V], labels [...]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)
