"""The plain reference: sparse-convolution networks in plain PyTorch.

It imports neither JAX nor anything of the program. From the raw inputs the
benchmark made (guard-biased voxel coordinates per scene, features, labels,
weights) it works out everything again: the coordinate set of every stride
level (``floor(c / 2^m) * 2^m``), every layer's kernel map (the input row
at ``out + delta_k`` for each offset ``delta_k`` of the ``K^3`` grid,
x-major, z fastest; ``out - delta_k`` for a transposed layer), the feature
pass (per offset a gather, a product and an add), the bias, ReLU and
per-scene standardisation in the layer's order, residual adds, the
classifier, and for training the masked cross-entropy, its gradients and
AdamW.

Rows are kept in (scene, x, y, z) order, the order of a packed word whose
most significant field is the scene. The arithmetic runs in the dtype it is
given: float64 for the reference itself, float32 with TF32 products for the
control that must fail.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

FIELD = 16          # bits per coordinate field of the reference's own keys
EPS_BN = 1e-5


@dataclasses.dataclass(frozen=True)
class Layer:
    """One sparse convolution of an architecture and what surrounds it.

    Its input is the previous layer's output, or the saved activation
    ``src``; ``concat`` names a saved activation appended to the input's
    channels. The convolution's map reads the input at ``out + delta_k``,
    or at ``out - delta_k`` where ``transposed`` (the transpose of the
    matching strided map). ``bias`` adds a bias. ``norm`` is ``relu_bn``
    (ReLU, then per-scene standardisation), ``bn_relu`` (the other way
    round) or ``bn`` (standardisation alone); ``add`` then adds a saved
    activation and takes the ReLU of the sum (a residual join). ``save``
    is the name the result is kept under."""

    name: str
    cin: int
    cout: int
    K: int
    m_in: int
    m_out: int
    concat: Optional[str] = None
    save: Optional[str] = None
    dataflow: str = "os"     # "os", "ws" or "hybrid": which kernels run
    t: int = 0               # hybrid: offsets with L1 norm < t are OS
    src: Optional[str] = None
    norm: str = "relu_bn"
    add: Optional[str] = None
    transposed: bool = False
    bias: bool = True

    def __post_init__(self):
        if self.norm not in NORMS:
            raise ValueError(f"layer {self.name}: norm {self.norm!r} is "
                             f"not one of {sorted(NORMS)}")

    def os_columns(self) -> np.ndarray:
        """Offset columns the output-stationary kernel computes."""
        l1 = np.abs(offsets(self.K, self.stride)).sum(1)
        if self.dataflow == "os":
            return np.ones(len(l1), bool)
        if self.dataflow == "ws":
            return np.zeros(len(l1), bool)
        return l1 < self.t

    @property
    def stride(self) -> int:
        return 1 << min(self.m_in, self.m_out)


def offsets(K: int, stride: int) -> np.ndarray:
    """The K^3 offsets, x-major, then y, z fastest: int64 [K^3, 3]."""
    half = (K - 1) // 2
    r = (np.arange(K) - half) * stride
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1)
    return g.reshape(-1, 3).astype(np.int64)


def keys(bxyz: torch.Tensor) -> torch.Tensor:
    """int64 keys of (scene, x, y, z) rows, ordered as the tuples are."""
    b, x, y, z = bxyz.unbind(-1)
    return (((b << FIELD | x) << FIELD | y) << FIELD) | z


def unkey(k: torch.Tensor) -> torch.Tensor:
    mask = (1 << FIELD) - 1
    return torch.stack([k >> (3 * FIELD), (k >> (2 * FIELD)) & mask,
                        (k >> FIELD) & mask, k & mask], dim=-1)


@dataclasses.dataclass
class Level:
    """One stride level: sorted (scene, x, y, z) rows and their keys."""

    bxyz: torch.Tensor     # int64 [n, 4]
    keys: torch.Tensor     # int64 [n], ascending
    sid: torch.Tensor      # int64 [n] scene of each row
    counts: torch.Tensor   # int64 [S] rows per scene


@dataclasses.dataclass
class Plan:
    """Every level and, per map (``pair_key``), each offset's valid
    (output row, input row) pairs."""

    levels: Dict[int, Level]
    pairs: Dict[Tuple[int, int, int, bool],
                List[Tuple[torch.Tensor, torch.Tensor]]]
    n_scenes: int
    order: torch.Tensor    # level-0 rows: position in the concatenated input


def _level(bxyz: torch.Tensor, n_scenes: int) -> Level:
    k = torch.unique(keys(bxyz))      # sorted
    rows = unkey(k)
    sid = rows[:, 0]
    counts = torch.bincount(sid, minlength=n_scenes)
    return Level(rows, k, sid, counts)


def build_plan(coords: Sequence[np.ndarray], layers: Sequence[Layer],
               device) -> Plan:
    """Levels and kernel maps of a batch of scenes (guard-biased int coords
    per scene; scene ``i`` is batch index ``i``)."""
    S = len(coords)
    raw = torch.cat([torch.cat([
        torch.full((len(c), 1), i, dtype=torch.int64),
        torch.from_numpy(np.asarray(c, np.int64))], 1)
        for i, c in enumerate(coords)]).to(device)
    k0 = keys(raw)
    sorted_k, order = torch.sort(k0)
    if sorted_k.numel() > 1 and bool((sorted_k[1:] == sorted_k[:-1]).any()):
        raise ValueError("reference input has duplicate voxels in a scene")
    rows0 = unkey(sorted_k)
    levels = {0: Level(rows0, sorted_k, rows0[:, 0],
                       torch.bincount(rows0[:, 0], minlength=S))}
    for m in sorted({lv for L in layers for lv in (L.m_in, L.m_out)}):
        if m:
            c = levels[0].bxyz.clone()
            c[:, 1:] = (c[:, 1:] >> m) << m
            levels[m] = _level(c, S)
    pairs = {}
    for L in layers:
        key = pair_key(L)
        if key in pairs:
            continue
        src, dst = levels[L.m_in], levels[L.m_out]
        cols = []
        for d in offsets(L.K, L.stride):
            q = dst.bxyz.clone()
            q[:, 1:] += torch.as_tensor(-d if L.transposed else d,
                                        device=q.device)
            qk = keys(q)
            pos = torch.searchsorted(src.keys, qk).clamp(
                max=src.keys.numel() - 1)
            hit = src.keys[pos] == qk
            rows = torch.nonzero(hit).flatten()
            cols.append((rows, pos[rows]))
        pairs[key] = cols
    return Plan(levels, pairs, S, order)


def pair_key(L: Layer) -> Tuple[int, int, int, bool]:
    """Layers with the same key share one kernel map."""
    return (L.m_in, L.m_out, L.K, L.transposed)


def layer_cols(plan: Plan, L: Layer) -> List[Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """A layer's kernel map: per offset column its valid (output row,
    input row) pairs."""
    return plan.pairs[pair_key(L)]


def layer_pairs(plan: Plan, L: Layer) -> np.ndarray:
    """Valid pairs of each offset column of a layer: int64 [K^3]."""
    return np.array([int(r.numel()) for r, _ in layer_cols(plan, L)],
                    np.int64)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 operands rounded to TF32's 10-bit mantissa (to nearest), as
    the tensor cores take them: the control's precision, the same on every
    device."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    # the rounding passes gradients straight through, as TF32 products do
    return x + (rounded - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product in the operands' dtype; float32 operands are rounded to
    TF32 where ``TF32`` is set (the control)."""
    if TF32["on"] and a.dtype == torch.float32:
        return tf32(a) @ tf32(b)
    return a @ b


TF32 = {"on": False}


class _SpConv(torch.autograd.Function):
    """``y[i] = sum_k x[m(i, k)] @ w[k]``, with its transposed-map backward
    written out, so no gathered activation is kept for autograd."""

    @staticmethod
    def forward(ctx, x, w, n_out, cols):
        ctx.save_for_backward(x, w)
        ctx.cols = cols
        y = x.new_zeros((n_out, w.shape[-1]))
        for k, (rows, src) in enumerate(cols):
            if rows.numel():
                y.index_add_(0, rows, mm(x[src], w[k]))
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        dw = torch.zeros_like(w)
        for k, (rows, src) in enumerate(ctx.cols):
            if not rows.numel():
                continue
            gk = g[rows]
            if dx is not None:
                dx.index_add_(0, src, mm(gk, w[k].t()))
            dw[k] = mm(x[src].t(), gk)
        return dx, dw, None, None


def standardise(y: torch.Tensor, lv: Level, n_scenes: int) -> torch.Tensor:
    """Per scene ``(y - mean) / sqrt(var + 1e-5)`` with the one-pass
    variance ``E[y^2] - mean^2`` (floored at 0), no affine."""
    S, C = n_scenes, y.shape[1]
    denom = lv.counts.to(y.dtype).clamp(min=1.0)[:, None]
    s1 = y.new_zeros((S, C)).index_add(0, lv.sid, y)
    s2 = y.new_zeros((S, C)).index_add(0, lv.sid, y * y)
    mean = s1 / denom
    var = (s2 / denom - mean * mean).clamp(min=0.0)
    inv = torch.rsqrt(var + EPS_BN)
    return (y - mean[lv.sid]) * inv[lv.sid]


NORMS = {
    "relu_bn": lambda y, lv, S: standardise(torch.relu(y), lv, S),
    "bn_relu": lambda y, lv, S: torch.relu(standardise(y, lv, S)),
    "bn": standardise,
}


def forward(plan: Plan, layers: Sequence[Layer], feats: torch.Tensor,
            weights: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Logits on the last layer's output level, rows in key order.
    ``feats`` are the level-0 rows in key order; ``weights`` holds
    ``layers.<name>.weight`` [K^3, Cin, Cout], ``layers.<name>.bias``
    [Cout] of the layers with a bias, and ``head`` [C, n_classes]."""
    saved: Dict[str, torch.Tensor] = {}
    x = feats
    for L in layers:
        if L.src is not None:
            x = saved[L.src]
        if L.concat is not None:
            x = torch.cat([x, saved[L.concat]], dim=1)
        lv = plan.levels[L.m_out]
        y = _SpConv.apply(x, weights[f"layers.{L.name}.weight"],
                          lv.keys.numel(), layer_cols(plan, L))
        if L.bias:
            y = y + weights[f"layers.{L.name}.bias"]
        x = NORMS[L.norm](y, lv, plan.n_scenes)
        if L.add is not None:
            x = torch.relu(x + saved[L.add])
        if L.save is not None:
            saved[L.save] = x
    return mm(x, weights["head"])


def input_rows(plan: Plan, feats: Sequence[np.ndarray], device,
               dtype) -> torch.Tensor:
    """Per-scene feature (or label) arrays, concatenated and put in the
    level-0 key order."""
    f = torch.from_numpy(np.concatenate(feats)).to(device)
    f = f[plan.order]
    return f.to(dtype) if f.is_floating_point() else f


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
    """Mean cross-entropy over the rows whose label is not negative."""
    valid = labels >= 0
    lab = labels.clamp(min=0, max=logits.shape[1] - 1).long()
    ce = -torch.log_softmax(logits, dim=1).gather(1, lab[:, None])[:, 0]
    w = valid.to(logits.dtype)
    return (ce * w).sum() / w.sum().clamp(min=1.0)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    grad_clip: float
    warmup_steps: int
    total_steps: int

    def lr_at(self, step: int) -> float:
        warm = min(1.0, (step + 1) / max(self.warmup_steps, 1))
        prog = min(max((step - self.warmup_steps)
                       / max(self.total_steps - self.warmup_steps, 1), 0.0),
                   1.0)
        return self.lr * warm * (0.1 + 0.45 * (1 + math.cos(math.pi * prog)))


def train_steps(plans: Sequence[Plan], feats: Sequence[torch.Tensor],
                labels: Sequence[torch.Tensor], layers: Sequence[Layer],
                weights: Dict[str, torch.Tensor], opt: AdamW) -> dict:
    """Train from ``weights`` (copied) one AdamW step per batch, with
    global-norm clipping. Returns each step's loss, every leaf's first
    gradient after clipping (what the optimizer applies) and every leaf's
    change over all the steps."""
    p = {k: v.detach().clone() for k, v in weights.items()}
    p0 = {k: v.clone() for k, v in p.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad = [], None
    for step, (plan, f, lab) in enumerate(zip(plans, feats, labels)):
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        with torch.enable_grad():
            loss = segmentation_loss(forward(plan, layers, f, leaves), lab)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp(opt.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        if first_grad is None:
            first_grad = {k: g * scale for k, g in grads.items()}
        lr = opt.lr_at(step)
        bc1, bc2 = 1 - opt.b1 ** (step + 1), 1 - opt.b2 ** (step + 1)
        with torch.no_grad():
            for k in p:
                g = grads[k] * scale
                mu[k] = opt.b1 * mu[k] + (1 - opt.b1) * g
                nu[k] = opt.b2 * nu[k] + (1 - opt.b2) * g * g
                delta = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + opt.eps) \
                    + opt.weight_decay * p[k]
                p[k] = (p[k] - lr * delta).detach()
    return {"losses": losses, "first_grad": first_grad,
            "change": {k: p[k] - p0[k] for k in p}}
