"""The paper's evaluation networks on the Spira engine (torch port of
``repro.models.pointcloud``): SparseResNet-21, MinkUNet-42,
CenterPoint-Large and the small ``tiny_segnet``, and the published
MinkUNet of SPVNAS / TorchSparse (:func:`minkunet`: residual blocks, K = 2
stride-2 and transposed convolutions, 1x1 shortcuts, bias-free layers
with BN before the ReLU).

A network is a list of :class:`SpConvSpec` and, per layer, a
:class:`LayerGraph` saying where its input comes from and what follows the
convolution (which saved activation it reads or concatenates, the norm
order, a residual add, the name its result is saved under); its
parameters are one :class:`PointCloudModel` holding a :class:`SpConv` per
layer plus the classifier ``head`` [C, n_classes]. All voxel indexing
happens once, up front (``core.build_network_plan``);
:func:`pointcloud_forward` then reads the plan's kernel maps layer by
layer.

Per-scene BN: batched rows are batch-major-sorted, so every per-scene
statistic is a reduction over a contiguous row segment, computed by the
segment engine (``kernels.segsum``) under its canonical add schedule.
Because that schedule depends only on a row's position relative to its
segment's start, a scene's statistics are bitwise the same alone or in a
batch, and under zero extension to a larger bucket. The OS and WS kernels
add each output element's terms in a fixed order, and the head runs over
fixed-shape row chunks, so a batch of B is bitwise equal to B single runs
(for WS at lossless capacity: a lossy one drops by position in the batch).

:func:`pointcloud_forward` is differentiable in the parameters and the
features: every sparse convolution carries its transposed-map backward
(``core.dataflow``), BN's segment sums and gathers are each other's
transposes (``kernels.segsum``), and the head's dW reduces in fixed row
panels, so parameter gradients are bitwise equal across capacity buckets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

# HEAD_ROWS and head_matmul are re-exported: the head lives in core.dataflow
from ..core.dataflow import (HEAD_ROWS, bcast_rows,  # noqa: F401
                             head_matmul, rowdot_matmul, rowsum)
from ..core.network_plan import NetworkPlan
from ..core.packing import BitLayout
from ..core.spconv import (SpConv, SpConvSpec, add_bias, init_spconv,
                           spconv_features)
from ..kernels.ops import resolve_backend
from ..kernels.segsum import (NORM_ORDERS, SegmentSpec, bn_stats,
                              relu_bn_cuda, segment_gather, segment_moments)


NORMS = ("relu_bn", "bn_relu", "bn")


@dataclasses.dataclass(frozen=True)
class LayerGraph:
    """What surrounds one convolution. Its input is the previous layer's
    output, or the saved activation ``src``; ``concat`` appends a saved
    activation's channels. After the convolution (and its bias) comes
    ``norm``: ``relu_bn`` (ReLU, then per-scene standardisation),
    ``bn_relu`` (the other way round) or ``bn`` (standardisation alone);
    ``add``, after ``bn`` alone, then adds a saved activation and takes the
    ReLU of the sum (a residual join). ``save`` keeps the result under a
    name."""

    src: Optional[str] = None
    concat: Optional[str] = None
    save: Optional[str] = None
    norm: str = "relu_bn"
    add: Optional[str] = None

    def __post_init__(self):
        if self.norm not in NORMS:
            raise ValueError(f"norm {self.norm!r} is not one of {NORMS}")
        if self.add is not None and self.norm != "bn":
            raise ValueError(f"a residual join follows norm 'bn' alone, got "
                             f"{self.norm!r}")

    @property
    def order(self) -> str:
        """The fused epilogue's order (``kernels.segsum.NORM_ORDERS``): the
        norm, or ``bn_add_relu`` for a residual join."""
        return self.norm if self.add is None else "bn_add_relu"


@dataclasses.dataclass(frozen=True)
class PointCloudNet:
    """Layers and their graph (``graph[i]`` surrounds ``specs[i]``; empty:
    a plain chain, every layer reading the previous one's output under
    ``relu_bn``)."""

    name: str
    specs: Tuple[SpConvSpec, ...]
    in_channels: int
    n_classes: int
    graph: Tuple[LayerGraph, ...] = ()

    def __post_init__(self):
        if not self.graph:
            object.__setattr__(self, "graph",
                               tuple(LayerGraph() for _ in self.specs))
        if len(self.graph) != len(self.specs):
            raise ValueError(f"{self.name}: {len(self.graph)} graph entries "
                             f"for {len(self.specs)} layers")
        saved = set()
        for s, g in zip(self.specs, self.graph):
            if s.bias and g.norm != "relu_bn":
                raise ValueError(f"{self.name}: layer {s.name} has a bias "
                                 f"before norm {g.norm!r}, which only "
                                 f"relu_bn follows")
            for ref in (g.src, g.concat, g.add):
                if ref is not None and ref not in saved:
                    raise ValueError(f"{self.name}: layer {s.name} reads "
                                     f"{ref!r}, saved by no earlier layer")
            if g.save is not None:
                saved.add(g.save)

    def conv_specs(self) -> Tuple[SpConvSpec, ...]:
        return self.specs


def _res_stage(name: str, c_in: int, c_out: int, m: int, n_blocks: int,
               K: int = 3, dataflow: str = "os", t: int = 0,
               backend: str = "auto") -> List[SpConvSpec]:
    """Downsample conv (except stage 0) + n_blocks residual submanifold pairs."""
    specs: List[SpConvSpec] = []
    if m > 0:
        specs.append(SpConvSpec(f"{name}_down", c_in, c_out, K=3,
                                m_in=m - 1, m_out=m, dataflow=dataflow,
                                backend=backend))
        c_in = c_out
    for b in range(n_blocks):
        specs.append(SpConvSpec(f"{name}_b{b}a", c_in, c_out, K=K, m_in=m,
                                m_out=m, dataflow=dataflow, t=t, backend=backend))
        specs.append(SpConvSpec(f"{name}_b{b}b", c_out, c_out, K=K, m_in=m,
                                m_out=m, dataflow=dataflow, t=t, backend=backend))
        c_in = c_out
    return specs


def sparse_resnet21(in_channels: int = 4, n_classes: int = 20,
                    width: Sequence[int] = (16, 32, 64, 128),
                    dataflow: str = "os", backend: str = "auto") -> PointCloudNet:
    """21 SpC layers: stem + 4 stages × (down + a residual pair) + head convs."""
    specs: List[SpConvSpec] = [
        SpConvSpec("stem", in_channels, width[0], K=3, m_in=0, m_out=0,
                   dataflow=dataflow, backend=backend)]
    c = width[0]
    for s, w in enumerate(width):
        specs += _res_stage(f"s{s}", c, w, m=s, n_blocks=1,
                            dataflow=dataflow, backend=backend)
        c = w
    while len(specs) < 21:
        specs.append(SpConvSpec(f"head{len(specs)}", c, c, K=3,
                                m_in=len(width) - 1, m_out=len(width) - 1,
                                dataflow=dataflow, backend=backend))
    return PointCloudNet("sparse_resnet21", tuple(specs), in_channels, n_classes)


def minkunet42(in_channels: int = 4, n_classes: int = 20,
               width: Sequence[int] = (32, 64, 128, 256),
               dataflow: str = "os", backend: str = "auto") -> PointCloudNet:
    """Encoder (4 downsample stages) + decoder (4 inverse-conv stages) with
    submanifold pairs at each level and UNet skips — 42 SpC layers. The
    skips: the stem's and each encoder stage's last output, saved by level
    (``l<m>``) and appended to the input of the decoder's first layer at
    that level."""
    specs: List[SpConvSpec] = []
    graph: List[LayerGraph] = []

    def conv(name, cin, cout, m_in, m_out, **g):
        specs.append(SpConvSpec(name, cin, cout, K=3, m_in=m_in, m_out=m_out,
                                dataflow=dataflow, backend=backend))
        graph.append(LayerGraph(**g))

    conv("stem0", in_channels, width[0], 0, 0)
    conv("stem1", width[0], width[0], 0, 0, save="l0")
    c = width[0]
    for s, w in enumerate(width):
        conv(f"enc{s}_down", c, w, s, s + 1)
        conv(f"enc{s}_a", w, w, s + 1, s + 1)
        conv(f"enc{s}_b", w, w, s + 1, s + 1, save=f"l{s + 1}")
        c = w
    dec_width = (128, 96, 96, 96)
    for s in range(4):
        lvl = 4 - s - 1
        w = dec_width[s]
        conv(f"dec{s}_up", c, w, lvl + 1, lvl)
        skip_c = width[lvl - 1] if lvl > 0 else width[0]
        conv(f"dec{s}_a", w + skip_c, w, lvl, lvl, concat=f"l{lvl}")
        conv(f"dec{s}_b", w, w, lvl, lvl)
        c = w
    i = 0
    while len(specs) < 42:
        conv(f"tail{i}", c, c, 0, 0)
        i += 1
    return PointCloudNet("minkunet42", tuple(specs), in_channels, n_classes,
                         tuple(graph))


def centerpoint_large(in_channels: int = 5, n_classes: int = 10,
                      width: Sequence[int] = (16, 32, 32, 64),
                      dataflow: str = "hybrid", t: int = 3,
                      backend: str = "auto") -> PointCloudNet:
    """CenterPoint-Large (ResNL): K=5 submanifold layers in all stages."""
    specs: List[SpConvSpec] = [
        SpConvSpec("stem", in_channels, width[0], K=5, m_in=0, m_out=0,
                   dataflow=dataflow, t=t, backend=backend)]
    c = width[0]
    for s, w in enumerate(width):
        specs += _res_stage(f"s{s}", c, w, m=s, n_blocks=1, K=5,
                            dataflow=dataflow, t=t, backend=backend)
        c = w
    while len(specs) < 20:
        specs.append(SpConvSpec(f"head{len(specs)}", c, c, K=5, m_in=3,
                                m_out=3, dataflow=dataflow, t=t, backend=backend))
    return PointCloudNet("centerpoint_large", tuple(specs), in_channels,
                         n_classes)


def tiny_segnet(in_channels: int = 4, n_classes: int = 8, width: int = 16,
                depth: int = 4, dataflow: str = "os",
                backend: str = "auto") -> PointCloudNet:
    """A small all-submanifold segmentation net (logits on the input set)."""
    specs: List[SpConvSpec] = [
        SpConvSpec("stem", in_channels, width, K=3, m_in=0, m_out=0,
                   dataflow=dataflow, backend=backend)]
    for i in range(depth - 1):
        specs.append(SpConvSpec(f"sub{i}", width, width, K=3, m_in=0, m_out=0,
                                dataflow=dataflow, backend=backend))
    return PointCloudNet("tiny_segnet", tuple(specs), in_channels, n_classes)


# the published MinkUNet's widths at cr = 1 (SPVNAS, core/models/
# semantic_kitti/minkunet.py): stem, four encoder stages, four decoder stages
MINKUNET_WIDTHS = (32, 32, 64, 128, 256, 256, 128, 96, 96)


def minkunet(in_channels: int = 4, n_classes: int = 19, cr: float = 1.0,
             dataflow: str = "os", backend: str = "auto") -> PointCloudNet:
    """The published MinkUNet of SPVNAS / TorchSparse (``MinkUNet``,
    widths ``MINKUNET_WIDTHS`` scaled by ``cr``): a stem of two K = 3
    convolutions at level 0; four encoder stages, stage i a K = 2 stride-2
    convolution from level i − 1 to i and two residual blocks; four decoder
    stages, stage j a K = 2 transposed convolution from level 5 − j to
    4 − j, its output concatenated with the encoder's (the stem's at level
    0) and two residual blocks. A residual block is conv K3 → BN → ReLU →
    conv K3 → BN, plus a shortcut (the identity, or a 1x1 convolution and
    BN where the width changes), then the sum's ReLU; the other
    convolutions are followed by BN and ReLU. 42 convolutions of K ≥ 2 and
    seven 1x1 shortcuts, all without a bias. The classifier is the port's
    bias-free head."""
    cs = [int(cr * c) for c in MINKUNET_WIDTHS]
    specs: List[SpConvSpec] = []
    graph: List[LayerGraph] = []

    def conv(name, cin, cout, K, m_in, m_out, transposed=False, **g):
        specs.append(SpConvSpec(name, cin, cout, K=K, m_in=m_in, m_out=m_out,
                                dataflow=dataflow, bias=False,
                                backend=backend, transposed=transposed))
        graph.append(LayerGraph(**g))

    def res_blocks(stage, cin, cout, m, inp, concat=None, out=None):
        """Two residual blocks at level m, the first reading ``inp`` (with
        ``concat`` appended), its shortcut a 1x1 projection where the
        width changes; the last block's result saved as ``out``."""
        sc = inp
        if cin != cout:
            conv(f"{stage}_proj", cin, cout, 1, m, m, concat=concat,
                 norm="bn", save=f"{stage}_sc")
            sc = f"{stage}_sc"
        conv(f"{stage}_b0a", cin, cout, 3, m, m, src=inp, concat=concat,
             norm="bn_relu")
        conv(f"{stage}_b0b", cout, cout, 3, m, m, norm="bn", add=sc,
             save=f"{stage}_r")
        conv(f"{stage}_b1a", cout, cout, 3, m, m, norm="bn_relu")
        conv(f"{stage}_b1b", cout, cout, 3, m, m, norm="bn",
             add=f"{stage}_r", save=out)

    conv("stem0", in_channels, cs[0], 3, 0, 0, norm="bn_relu")
    conv("stem1", cs[0], cs[0], 3, 0, 0, norm="bn_relu", save="x0")
    for i in range(1, 5):
        conv(f"enc{i}_down", cs[i - 1], cs[i - 1], 2, i - 1, i,
             norm="bn_relu", save=f"enc{i}_in")
        res_blocks(f"enc{i}", cs[i - 1], cs[i], i, f"enc{i}_in", out=f"x{i}")
    c = cs[4]
    for j in range(1, 5):
        lvl = 4 - j
        w = cs[4 + j]
        conv(f"dec{j}_up", c, w, 2, lvl + 1, lvl, transposed=True,
             norm="bn_relu", save=f"dec{j}_in")
        res_blocks(f"dec{j}", w + cs[lvl], w, lvl, f"dec{j}_in",
                   concat=f"x{lvl}")
        c = w
    return PointCloudNet("minkunet", tuple(specs), in_channels, n_classes,
                         tuple(graph))


NETWORKS = {
    "sparse_resnet21": sparse_resnet21,
    "minkunet42": minkunet42,
    "centerpoint_large": centerpoint_large,
    "tiny_segnet": tiny_segnet,
    "minkunet": minkunet,
}


# ---------------------------------------------------------------------------
# parameters + feature pass
# ---------------------------------------------------------------------------

class PointCloudModel(nn.Module):
    """Parameters of a :class:`PointCloudNet`: one :class:`SpConv` per
    layer (``layers[spec.name]``) and the classifier ``head``
    [C_last, n_classes]."""

    def __init__(self, net: PointCloudNet, layers: Dict[str, SpConv],
                 head: torch.Tensor):
        super().__init__()
        self.net = net
        self.layers = nn.ModuleDict(layers)
        self.head = nn.Parameter(head)

    def forward(self, plan: NetworkPlan, features: torch.Tensor, *,
                layout: Optional[BitLayout] = None,
                segment: Optional[SegmentSpec] = None) -> torch.Tensor:
        return pointcloud_forward(self, self.net, plan, features,
                                  layout=layout, segment=segment)


def init_pointcloud(net: PointCloudNet, *, seed: int = 0, device="cuda",
                    dtype=torch.float32) -> PointCloudModel:
    """Random weights from ``torch.Generator().manual_seed(seed)``, drawn on
    the CPU so one seed gives the same model on every device."""
    gen = torch.Generator().manual_seed(seed)
    layers = {s.name: init_spconv(s, generator=gen, device=device,
                                  dtype=dtype) for s in net.specs}
    head = torch.randn((net.specs[-1].cout, net.n_classes), generator=gen,
                       dtype=torch.float32) * 0.02
    return PointCloudModel(net, layers, head.to(device=device, dtype=dtype))


def jax_param_paths(net: PointCloudNet) -> Dict[str, str]:
    """The port's parameter names → the JAX tree's ``/``-joined paths
    (``layers.stem.weight`` → ``stem/w``, ``layers.stem.bias`` →
    ``stem/b``, ``head`` → ``head``), in the order of ``net.specs``."""
    out = {}
    for s in net.specs:
        out[f"layers.{s.name}.weight"] = f"{s.name}/w"
        if s.bias:
            out[f"layers.{s.name}.bias"] = f"{s.name}/b"
    out["head"] = "head"
    return out


def jax_tree(named: Mapping[str, object], net: PointCloudNet) -> dict:
    """Values keyed by the port's parameter names (the parameters, or an
    AdamW moment) nested as the JAX package's parameter tree
    ``{layer: {"w", "b"?}, "head"}``; the leaves are the given objects."""
    tree: dict = {}
    for port, path in jax_param_paths(net).items():
        *outer, leaf = path.split("/")
        node = tree
        for k in outer:
            node = node.setdefault(k, {})
        node[leaf] = named[port]
    return tree


def _bn(x: torch.Tensor, count: torch.Tensor, seg: Optional[tuple] = None,
        *, segment: Optional[SegmentSpec] = None) -> torch.Tensor:
    """Masked per-scene feature standardization (train-mode BN, no affine)
    on the segment engine. ``seg = (sid, starts, counts, S)``
    (:func:`level_segments`); ``None`` is the single-scene S=1 case over
    the valid prefix. Moments are one segment sum of ``concat([z, z²])``
    (one-pass var = E[x²] − mean²); the per-scene application is a segment
    gather of ``concat([mean, inv])``; rows outside every scene get +0."""
    cap, c = x.shape
    dev = x.device
    if seg is None:
        sid = torch.where(torch.arange(cap, device=dev) < count, 0, 1).to(
            torch.int32)
        starts = torch.zeros(1, dtype=torch.int32, device=dev)
        counts = count.to(torch.int32).reshape(1)
        S = 1
    else:
        sid, starts, counts, S = seg
    sx, sx2 = segment_moments(x, sid, starts, counts, num_segments=S,
                              spec=segment)
    stats = bn_stats(sx, sx2, counts).to(x.dtype)
    r = segment_gather(stats, sid, starts, counts, num_segments=S,
                       spec=segment)
    return torch.where((sid < S)[:, None], (x - r[:, :c]) * r[:, c:],
                       torch.zeros((), dtype=x.dtype, device=dev))


def _relu_bn(x: torch.Tensor, count: torch.Tensor, seg: Optional[tuple] = None,
             *, segment: Optional[SegmentSpec] = None) -> torch.Tensor:
    """ReLU + masked per-scene feature standardization (:func:`_bn`)."""
    return _bn(torch.relu(x), count, seg, segment=segment)


def _bn_relu(x: torch.Tensor, count: torch.Tensor, seg: Optional[tuple] = None,
             *, segment: Optional[SegmentSpec] = None) -> torch.Tensor:
    """Per-scene standardization (:func:`_bn`), then ReLU."""
    return torch.relu(_bn(x, count, seg, segment=segment))


def _bn_add_relu(x: torch.Tensor, residual: torch.Tensor,
                 count: torch.Tensor, seg: Optional[tuple] = None, *,
                 segment: Optional[SegmentSpec] = None) -> torch.Tensor:
    """A residual join: per-scene standardization (:func:`_bn`), plus the
    shortcut ``residual``, then ReLU."""
    return torch.relu(_bn(x, count, seg, segment=segment) + residual)


_CHAIN_NORMS = {"relu_bn": _relu_bn, "bn_relu": _bn_relu, "bn": _bn}

# layers of the feature pass through the fused epilogue (two kernels) and
# through the chain of torch ops (bias add, row mask, norm, residual add);
# beside them the fused layers by norm order (kernels.segsum.NORM_ORDERS)
EPILOGUE_CALLS = {"fused": 0, "chain": 0,
                  **{o: 0 for o in NORM_ORDERS}}


def reset_epilogue_calls() -> None:
    for k in EPILOGUE_CALLS:
        EPILOGUE_CALLS[k] = 0


def fused_epilogue_count() -> int:
    return EPILOGUE_CALLS["fused"]


def chain_epilogue_count() -> int:
    return EPILOGUE_CALLS["chain"]


def _conv_epilogue(out: torch.Tensor, bias: Optional[torch.Tensor],
                   spec: SpConvSpec, count: torch.Tensor,
                   seg: Optional[tuple], *,
                   segment: Optional[SegmentSpec] = None,
                   order: str = "relu_bn",
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bias, PAD-row mask, the norm and a residual join after one
    convolution (``out``: :func:`~repro_torch.core.spconv.spconv_features`'
    output; ``bias`` in its dtype, on a ``relu_bn`` layer alone; ``order``
    as :attr:`LayerGraph.order`, ``residual`` the saved activation of
    ``bn_add_relu``). The fused kernels (``kernels.segsum.relu_bn_cuda``)
    where they give the chain's bits and autograd records nothing: fp32 on
    CUDA with the segment engine's kernel backend, and no gradient to
    carry; the chain (``add_bias``, then :func:`_relu_bn`, :func:`_bn_relu`,
    :func:`_bn` or :func:`_bn_add_relu`) everywhere else, training among
    it."""
    sp = segment or SegmentSpec()
    grad = torch.is_grad_enabled() and (
        out.requires_grad or (bias is not None and bias.requires_grad)
        or (residual is not None and residual.requires_grad))
    if (not grad and out.device.type == "cuda"
            and out.dtype == torch.float32
            and (bias is None or bias.dtype == torch.float32)
            and (residual is None or (residual.dtype == torch.float32
                                      and residual.device == out.device))
            and resolve_backend(sp.backend, out)):
        EPILOGUE_CALLS["fused"] += 1
        EPILOGUE_CALLS[order] += 1
        return relu_bn_cuda(out, count, seg, bias=bias,
                            mask=bias is not None and not spec.dense, q=sp.q,
                            order=order, residual=residual)
    EPILOGUE_CALLS["chain"] += 1
    x = add_bias(out, bias, spec, count)
    if order == "bn_add_relu":
        return _bn_add_relu(x, residual, count, seg, segment=segment)
    return _CHAIN_NORMS[order](x, count, seg, segment=segment)


# calls of the retired O(S·cap) BN baseline: no session or trainer path may
# call it, so this stays 0 while the segment engine's count grows
SLICED_BN_CALLS = {"count": 0}


def reset_sliced_bn_calls() -> None:
    SLICED_BN_CALLS["count"] = 0


def sliced_bn_call_count() -> int:
    return SLICED_BN_CALLS["count"]


def _relu_bn_sliced(x: torch.Tensor, count: torch.Tensor,
                    seg: Optional[tuple] = None) -> torch.Tensor:
    """The RETIRED O(S·cap) per-scene BN: per scene a capacity-wide slice
    aligned at its first row for the statistics (whole-buffer
    :func:`~repro_torch.core.dataflow.rowsum` reductions), then a
    ``[cap, S]`` one-hot matmul to apply them. Kept as the baseline the
    benchmarks price the segment engine against and as a numerical
    cross-check of :func:`_relu_bn`; nothing on the session or training
    path calls it (``SLICED_BN_CALLS``)."""
    SLICED_BN_CALLS["count"] += 1
    x = torch.relu(x)
    cap, c = x.shape
    dev = x.device

    def stats(v, valid, cnt):
        z = torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=dev))
        sm = rowsum(torch.cat([z, z * z], dim=1))
        denom = cnt.to(v.dtype).clamp(min=1.0)
        mean, ex2 = sm[:c] / denom, sm[c:] / denom
        var = (ex2 - mean * mean).clamp(min=0.0)
        return mean, torch.rsqrt(var + 1e-5)

    zero = torch.zeros((), dtype=x.dtype, device=dev)
    if seg is None or seg[3] == 1:
        mask = (torch.arange(cap, device=dev) < count)[:, None]
        mean, inv = stats(x, mask, count)
        return torch.where(mask, (x - bcast_rows(mean, cap))
                           * bcast_rows(inv, cap), zero)
    sid, starts, counts, S = seg
    xpad = torch.cat([x, torch.zeros_like(x)])
    local = torch.arange(cap, device=dev)
    means, invs = [], []
    for b in range(S):
        # a capacity-wide window from the scene's first row (the
        # reference's dynamic_slice, its start clamped the same way)
        start = starts[b].clamp(0, cap)
        sl = xpad[start + local]
        mean, inv = stats(sl, (local < counts[b])[:, None], counts[b])
        means.append(mean)
        invs.append(inv)
    sid_c = sid.clamp(0, S - 1)
    onehot = (sid_c[:, None] == torch.arange(S, device=dev)[None, :]).to(
        x.dtype)
    mean_r = onehot @ torch.stack(means)
    inv_r = onehot @ torch.stack(invs)
    return torch.where((sid < S)[:, None], (x - mean_r) * inv_r, zero)


def packed_segments(packed: torch.Tensor, count: torch.Tensor,
                    layout: BitLayout) -> tuple:
    """Scene segmentation ``(sid, starts, counts, S)`` of one packed-row
    buffer from its batch bits (the segment engine's input contract); PAD
    rows get scene id S."""
    S = 1 << layout.bb
    dev = packed.device
    rows = torch.arange(packed.shape[0], device=dev)
    sid_raw = (packed >> layout.shift_b).to(torch.int32) & (S - 1)
    sid = torch.where(rows < count, sid_raw, S).to(torch.int32)
    scene_ids = torch.arange(S, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(sid, scene_ids, side="left", out_int32=True)
    ends = torch.searchsorted(sid, scene_ids, side="right", out_int32=True)
    return (sid, starts, ends - starts, S)


def level_segments(plan: NetworkPlan, layout: BitLayout) -> Dict[int, tuple]:
    """:func:`packed_segments` of every level's coordinate set."""
    return {m: packed_segments(cs.packed, cs.count, layout)
            for m, cs in plan.coords.items()}


def pointcloud_forward(params: PointCloudModel, net: PointCloudNet,
                       plan: NetworkPlan, features: torch.Tensor, *,
                       layout: Optional[BitLayout] = None,
                       segment: Optional[SegmentSpec] = None) -> torch.Tensor:
    """The feature pass over a precomputed plan, each layer's input, norm
    and residual join as its :class:`LayerGraph` says (UNet skips are
    saved activations appended with ``concat``). With a batched
    ``layout`` (``bb > 0``), BN statistics are per scene."""
    missing = [s.name for s in net.specs if s.name not in plan.kmaps]
    if missing:
        raise ValueError(
            f"plan has no kernel map for layer(s) {missing[:3]} — it was "
            "built for different specs than this network's")
    lvl0 = net.specs[0].m_in
    in_cap = plan.coords[lvl0].capacity
    if features.shape[0] != in_cap:
        raise ValueError(
            f"features rows ({features.shape[0]}) != plan input capacity "
            f"({in_cap}); pad features to the plan's V0 capacity")
    segs = level_segments(plan, layout) if (layout and layout.bb) else {}
    # a saved activation is dropped after its last reader
    last = {ref: i for i, g in enumerate(net.graph)
            for ref in (g.src, g.concat, g.add) if ref is not None}
    saved: Dict[str, torch.Tensor] = {}
    x = features
    for i, (spec, g) in enumerate(zip(net.specs, net.graph)):
        kmap = plan.kmaps[spec.name]
        if g.src is not None:
            x = saved[g.src]
        if g.concat is not None:
            x = torch.cat([x, saved[g.concat]], dim=-1)
        layer = params.layers[spec.name]
        bias = None if layer.bias is None else layer.bias.to(x.dtype)
        x = _conv_epilogue(spconv_features(layer, spec, x, kmap), bias, spec,
                           kmap.out_count, segs.get(spec.m_out),
                           segment=segment, order=g.order,
                           residual=None if g.add is None else saved[g.add])
        for ref in [r for r, at in last.items() if at == i]:
            saved.pop(ref, None)
        if g.save is not None:
            saved[g.save] = x
    # the head's dW reduces over the capacity axis: rowdot_matmul keeps that
    # contraction's grouping capacity-stable (core.dataflow)
    return rowdot_matmul(x, params.head.to(x.dtype),
                         backend=net.specs[-1].backend)
