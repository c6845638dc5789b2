"""The paper's evaluation networks on the Spira engine (torch port of
``repro.models.pointcloud``): SparseResNet-21, MinkUNet-42,
CenterPoint-Large and the small ``tiny_segnet``.

A network is a list of :class:`SpConvSpec`; its parameters are one
:class:`PointCloudModel` holding a :class:`SpConv` per layer plus the
classifier ``head`` [C, n_classes]. All voxel indexing happens once, up
front (``core.build_network_plan``); :func:`pointcloud_forward` then reads
the plan's kernel maps layer by layer.

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
from ..kernels.segsum import (SegmentSpec, bn_stats, relu_bn_cuda,
                              segment_gather, segment_moments)


@dataclasses.dataclass(frozen=True)
class PointCloudNet:
    name: str
    specs: Tuple[SpConvSpec, ...]
    in_channels: int
    n_classes: int

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
    submanifold pairs at each level and UNet skips — 42 SpC layers."""
    specs: List[SpConvSpec] = [
        SpConvSpec("stem0", in_channels, width[0], K=3, m_in=0, m_out=0,
                   dataflow=dataflow, backend=backend),
        SpConvSpec("stem1", width[0], width[0], K=3, m_in=0, m_out=0,
                   dataflow=dataflow, backend=backend)]
    c = width[0]
    for s, w in enumerate(width):
        specs.append(SpConvSpec(f"enc{s}_down", c, w, K=3, m_in=s, m_out=s + 1,
                                dataflow=dataflow, backend=backend))
        specs.append(SpConvSpec(f"enc{s}_a", w, w, K=3, m_in=s + 1, m_out=s + 1,
                                dataflow=dataflow, backend=backend))
        specs.append(SpConvSpec(f"enc{s}_b", w, w, K=3, m_in=s + 1, m_out=s + 1,
                                dataflow=dataflow, backend=backend))
        c = w
    dec_width = (128, 96, 96, 96)
    for s in range(4):
        lvl = 4 - s - 1
        w = dec_width[s]
        specs.append(SpConvSpec(f"dec{s}_up", c, w, K=3, m_in=lvl + 1,
                                m_out=lvl, dataflow=dataflow, backend=backend))
        skip_c = width[lvl - 1] if lvl > 0 else width[0]
        specs.append(SpConvSpec(f"dec{s}_a", w + skip_c, w, K=3, m_in=lvl,
                                m_out=lvl, dataflow=dataflow, backend=backend))
        specs.append(SpConvSpec(f"dec{s}_b", w, w, K=3, m_in=lvl, m_out=lvl,
                                dataflow=dataflow, backend=backend))
        c = w
    i = 0
    while len(specs) < 42:
        specs.append(SpConvSpec(f"tail{i}", c, c, K=3, m_in=0, m_out=0,
                                dataflow=dataflow, backend=backend))
        i += 1
    return PointCloudNet("minkunet42", tuple(specs), in_channels, n_classes)


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


NETWORKS = {
    "sparse_resnet21": sparse_resnet21,
    "minkunet42": minkunet42,
    "centerpoint_large": centerpoint_large,
    "tiny_segnet": tiny_segnet,
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


def _relu_bn(x: torch.Tensor, count: torch.Tensor, seg: Optional[tuple] = None,
             *, segment: Optional[SegmentSpec] = None) -> torch.Tensor:
    """ReLU + masked per-scene feature standardization (train-mode BN) on
    the segment engine. ``seg = (sid, starts, counts, S)``
    (:func:`level_segments`); ``None`` is the single-scene S=1 case over
    the valid prefix. Moments are one segment sum of ``concat([z, z²])``
    (one-pass var = E[x²] − mean²); the per-scene application is a segment
    gather of ``concat([mean, inv])``."""
    x = torch.relu(x)
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


# layers of the feature pass through the fused epilogue (two kernels) and
# through the chain of torch ops (bias add, row mask, _relu_bn)
EPILOGUE_CALLS = {"fused": 0, "chain": 0}


def reset_epilogue_calls() -> None:
    EPILOGUE_CALLS["fused"] = EPILOGUE_CALLS["chain"] = 0


def fused_epilogue_count() -> int:
    return EPILOGUE_CALLS["fused"]


def chain_epilogue_count() -> int:
    return EPILOGUE_CALLS["chain"]


def _conv_epilogue(out: torch.Tensor, bias: Optional[torch.Tensor],
                   spec: SpConvSpec, count: torch.Tensor,
                   seg: Optional[tuple], *,
                   segment: Optional[SegmentSpec] = None) -> torch.Tensor:
    """Bias, PAD-row mask, ReLU and per-scene BN after one convolution
    (``out``: :func:`~repro_torch.core.spconv.spconv_features`' output;
    ``bias`` in its dtype). The fused kernels (``kernels.segsum.relu_bn_cuda``)
    where they give the chain's bits and autograd records nothing: fp32 on
    CUDA with the segment engine's kernel backend, and no gradient to
    carry; the chain (``add_bias``, then :func:`_relu_bn`) everywhere else,
    training among it."""
    sp = segment or SegmentSpec()
    grad = torch.is_grad_enabled() and (
        out.requires_grad or (bias is not None and bias.requires_grad))
    if (not grad and out.device.type == "cuda"
            and out.dtype == torch.float32
            and (bias is None or bias.dtype == torch.float32)
            and resolve_backend(sp.backend, out)):
        EPILOGUE_CALLS["fused"] += 1
        return relu_bn_cuda(out, count, seg, bias=bias,
                            mask=bias is not None and not spec.dense, q=sp.q)
    EPILOGUE_CALLS["chain"] += 1
    return _relu_bn(add_bias(out, bias, spec, count), count, seg,
                    segment=segment)


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
    """The feature pass over a precomputed plan. UNet skips: encoder outputs
    are stashed per level and concatenated (channels) at ``dec*_a``. With a
    batched ``layout`` (``bb > 0``), BN statistics are per scene."""
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
    skips: Dict[int, torch.Tensor] = {}
    x = features
    for spec in net.specs:
        kmap = plan.kmaps[spec.name]
        if spec.name.startswith("dec") and spec.name.endswith("_a"):
            skip = skips.get(spec.m_in)
            if skip is not None:
                x = torch.cat([x, skip], dim=-1)
        layer = params.layers[spec.name]
        bias = None if layer.bias is None else layer.bias.to(x.dtype)
        x = _conv_epilogue(spconv_features(layer, spec, x, kmap), bias, spec,
                           kmap.out_count, segs.get(spec.m_out),
                           segment=segment)
        if spec.name.startswith("enc") and spec.name.endswith("_b"):
            skips[spec.m_out] = x
        if spec.name.startswith("stem"):
            skips[0] = x
    # the head's dW reduces over the capacity axis: rowdot_matmul keeps that
    # contraction's grouping capacity-stable (core.dataflow)
    return rowdot_matmul(x, params.head.to(x.dtype),
                         backend=net.specs[-1].backend)
