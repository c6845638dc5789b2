"""Point-cloud training on the Spira engine (torch port of
``repro.train.pointcloud``).

* **One plan per step, shared by forward and backward.** The plan is built
  under ``torch.no_grad()``; only the feature pass carries autograd. Every
  sparse convolution's backward runs over (a mirror scatter of) the
  forward kernel map (``core.dataflow``), so a step performs exactly the
  kernel-map searches of one inference plan and the backward none.
* **Same kernels both directions.** On the card the OS and WS kernels
  compute dF over the transposed maps, the dW kernel the weight gradients,
  and the segment-sum kernel the BN and loss reductions of both passes
  (``segment_sum`` ⇄ ``segment_gather`` are each other's backward).
* **Same bucketing as inference.** :class:`PointCloudTrainer` pads every
  batch to the session's pow2 capacity bucket (labels with the ignore
  label); ``compile_count`` is the number of distinct buckets seen.
* **Bucket-invariant gradients.** Every reduction over a capacity-sized
  axis on the path — BN moments, the loss, dW, the bias and head
  gradients — adds in a fixed order relative to the row's position, so
  parameter gradients are bitwise equal when a batch is zero-extended to
  a larger bucket.

Data contract: per-voxel class labels aligned with the raw point cloud
(``data.scenes.scene_batch(labels=True)``). :func:`labeled_tensor` carries
the labels through SparseTensor's sort/dedup as an extra feature column.
The loss is masked cross-entropy over rows with ``label >= 0``; it needs
the network's output level to be its input level (``tiny_segnet``,
``minkunet42``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.network_plan import build_network_plan
from ..core.packing import BitLayout
from ..core.sparse_tensor import SparseTensor, ensure_sparse_tensor
from ..data.scenes import GUARD, Scene
from ..kernels.segsum import SegmentSpec, segment_sum
from ..models.pointcloud import (PointCloudModel, PointCloudNet,
                                 packed_segments, pointcloud_forward)
from ..obs import MetricsRegistry, span
from .optimizer import AdamWConfig, OptState, apply_updates, init_opt_state


@dataclasses.dataclass(frozen=True)
class PointCloudTrainConfig:
    """Training configuration: AdamW sized for the smoke-scale
    segmentation task (short schedule, no weight decay: BN has no affine
    parameters to exempt) and the label that marks unsupervised rows."""

    opt: AdamWConfig = dataclasses.field(default_factory=lambda: AdamWConfig(
        lr=1e-2, warmup_steps=5, total_steps=2000, weight_decay=0.0))
    ignore_label: int = -1

    def __post_init__(self):
        if self.ignore_label >= 0:
            raise ValueError(
                f"ignore_label must be negative (got {self.ignore_label}): "
                "segmentation_loss masks rows by label < 0, so a non-"
                "negative ignore value would make PAD/bucket-padding rows "
                "train as real voxels. Remap a 255-style ignore convention "
                "to -1 in your label pipeline.")


# ---------------------------------------------------------------------------
# data plumbing: labels through the packing step
# ---------------------------------------------------------------------------

def scene_features(scene: Scene, channels: int = 4) -> np.ndarray:
    """Coordinate-derived input features: normalized (x, y, z) and a
    constant channel, tiled or trimmed to ``channels`` — the geometric
    signal ``scenes.semantic_labels`` encodes is linearly present."""
    c = (scene.coords.astype(np.float32) - GUARD) / np.asarray(
        scene.extent, np.float32)
    base = np.concatenate([c, np.ones((len(c), 1), np.float32)], axis=1)
    reps = -(-channels // base.shape[1])
    return np.tile(base, (1, reps))[:, :channels].astype(np.float32)


def labeled_tensor(clouds: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                   layout: BitLayout, *, capacity: Optional[int] = None,
                   ignore_label: int = -1, validate: str = "reject",
                   device="cuda") -> Tuple[SparseTensor, torch.Tensor]:
    """Pack B labeled scenes ``[(coords, features, labels), ...]`` into one
    batched SparseTensor and a row-aligned int32 label vector on
    ``device``. Labels ride through the sort/dedup as an extra feature
    column (exact for class ids < 2²⁴ in fp32); PAD rows get
    ``ignore_label``."""
    if ignore_label >= 0:
        raise ValueError(f"ignore_label must be negative (got "
                         f"{ignore_label}): the loss masks rows by "
                         "label < 0 (PointCloudTrainConfig doc).")
    aug = []
    for coords, feats, labels in clouds:
        if len(labels) != len(coords):
            raise ValueError(f"labels rows ({len(labels)}) must match coords "
                             f"rows ({len(coords)})")
        aug.append((coords, np.concatenate(
            [np.asarray(feats, np.float32),
             np.asarray(labels, np.float32)[:, None]], axis=1)))
    st = SparseTensor.from_point_clouds(aug, layout, capacity=capacity,
                                        validate=validate, device=device)
    n = int(st.count)
    lab = torch.round(st.features[:, -1]).to(torch.int32)
    lab[n:] = ignore_label
    return (SparseTensor(features=st.features[:, :-1].contiguous(),
                         packed=st.packed, count=st.count, layout=st.layout,
                         validation=st.validation), lab)


def labeled_batch(batch: Sequence[Scene], layout: BitLayout, *,
                  channels: int = 4, capacity: Optional[int] = None,
                  ignore_label: int = -1, validate: str = "reject",
                  device="cuda") -> Tuple[SparseTensor, torch.Tensor]:
    """``scene_batch(labels=True)`` output → (SparseTensor, labels), with
    :func:`scene_features` as inputs."""
    for sc in batch:
        if sc.labels is None:
            raise ValueError("scene has no labels — generate the batch with "
                             "data.scenes.scene_batch(..., labels=True)")
    return labeled_tensor(
        [(sc.coords, scene_features(sc, channels), sc.labels)
         for sc in batch], layout, capacity=capacity,
        ignore_label=ignore_label, validate=validate, device=device)


# ---------------------------------------------------------------------------
# loss + train step
# ---------------------------------------------------------------------------

def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                      seg: Optional[tuple] = None,
                      segment: Optional[SegmentSpec] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean cross-entropy and accuracy over rows with
    ``label >= 0`` (0-d tensors). Out-of-range labels are clipped into the
    class range; a batch with no supervised row gives an exact 0 (the
    denominator is ``max(Σw, 1)``).

    The row reduction runs on the segment engine: one segment sum yields
    per scene (Σ ce·w, Σ w, Σ hit·w), added over the S scenes. ``seg =
    (sid, starts, counts, S)`` is the output level's scene segmentation
    (``models.pointcloud.level_segments``); ``seg=None`` reduces the whole
    buffer as one segment (the reference sums with ``jnp.sum`` there), so
    the loss and every logit gradient are bitwise equal across capacity
    buckets either way."""
    valid = labels >= 0
    lab = labels.clamp(0, logits.shape[-1] - 1).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, 1, lab[:, None])[:, 0]
    w = valid.to(torch.float32)
    hit = (torch.argmax(logp, dim=-1) == lab).to(torch.float32)
    if seg is None:
        cap, dev = logits.shape[0], logits.device
        i32 = torch.int32
        seg = (torch.zeros(cap, dtype=i32, device=dev),
               torch.zeros(1, dtype=i32, device=dev),
               torch.full((1,), cap, dtype=i32, device=dev), 1)
    sid, starts, counts, S = seg
    per_scene = segment_sum(torch.stack([ce * w, w, hit * w], dim=1), sid,
                            starts, counts, num_segments=S, spec=segment)
    tot = per_scene.sum(dim=0)
    denom = torch.clamp(tot[1], min=1.0)
    return tot[0] / denom, tot[2] / denom


def scene_pool(st: SparseTensor, *, mode: str = "mean",
               segment: Optional[SegmentSpec] = None) -> torch.Tensor:
    """Per-scene pooled feature vectors ``[num_scenes, C]``: sum or mean
    pooling over each scene's rows through the segment engine (batched
    pooling is bitwise equal to pooling each scene alone)."""
    if mode not in ("mean", "sum"):
        raise ValueError(f"mode must be 'mean' or 'sum', got {mode!r}")
    sid, starts, counts, S = packed_segments(st.packed, st.count, st.layout)
    s = segment_sum(st.features, sid, starts, counts, num_segments=S,
                    spec=segment)
    if mode == "mean":
        s = s / counts.to(torch.float32).clamp(min=1.0)[:, None]
    return s.to(st.features.dtype)


def make_segmentation_loss_fn(
    net: PointCloudNet,
    layout: BitLayout,
    *,
    engine: str = "zdelta_cuda",
    downsample_method: str = "auto",
    segment: Optional[SegmentSpec] = None,
) -> Callable:
    """The plan → forward → loss chain as ``loss_fn(params, packed, feats,
    labels) -> (loss, accuracy)``. The plan is built without autograd.
    Raises ``ValueError`` unless the net ends on its input level
    (per-voxel supervision)."""
    specs = net.conv_specs()
    in_level = specs[0].m_in if specs else 0
    out_level = specs[-1].m_out if specs else 0
    if out_level != in_level:
        raise ValueError(
            f"{net.name} ends at level {out_level} but its input is level "
            f"{in_level}: per-voxel labels can't supervise coarser logits. "
            "Train a submanifold-ending segmentation net (tiny_segnet, "
            "minkunet42) or pool the labels to the output level yourself.")

    def loss_fn(params: PointCloudModel, packed, feats, labels):
        with torch.no_grad():
            plan = build_network_plan(packed, specs=specs, layout=layout,
                                      engine=engine,
                                      downsample_method=downsample_method)
        logits = pointcloud_forward(params, net, plan, feats, layout=layout,
                                    segment=segment)
        out_cs = plan.coords[out_level]
        seg = (packed_segments(out_cs.packed, out_cs.count, layout)
               if layout.bb else None)
        return segmentation_loss(logits, labels, seg=seg, segment=segment)

    return loss_fn


def make_grad_fn(
    net: PointCloudNet,
    layout: BitLayout,
    *,
    engine: str = "zdelta_cuda",
    downsample_method: str = "auto",
    segment: Optional[SegmentSpec] = None,
) -> Callable:
    """The plan → forward → loss → backward chain as ``grad_fn(params,
    packed, feats, labels) -> (named, grads, loss, accuracy)``: the
    parameters by name, their gradients under the same names, and the
    detached 0-d loss and accuracy."""
    loss_fn = make_segmentation_loss_fn(
        net, layout, engine=engine, downsample_method=downsample_method,
        segment=segment)

    def grad_fn(params: PointCloudModel, packed, feats, labels):
        named = dict(params.named_parameters())
        with torch.enable_grad():
            loss, acc = loss_fn(params, packed, feats, labels)
            grads = torch.autograd.grad(loss, list(named.values()))
        return named, dict(zip(named, grads)), loss.detach(), acc.detach()

    return grad_fn


def make_pointcloud_train_step(
    net: PointCloudNet,
    layout: BitLayout,
    tcfg: PointCloudTrainConfig,
    *,
    engine: str = "zdelta_cuda",
    downsample_method: str = "auto",
    segment: Optional[SegmentSpec] = None,
) -> Callable:
    """The plan → forward → loss → backward → AdamW step as
    ``step(params, opt_state, packed, feats, labels) -> (params, opt_state,
    metrics)``. ``params`` (a :class:`PointCloudModel`) is updated in
    place and returned; ``metrics`` holds 0-d tensors ``loss``,
    ``accuracy``, ``grad_norm`` and the float ``lr``."""
    grad_fn = make_grad_fn(net, layout, engine=engine,
                           downsample_method=downsample_method,
                           segment=segment)

    def step(params: PointCloudModel, opt_state: OptState, packed, feats,
             labels):
        named, grads, loss, acc = grad_fn(params, packed, feats, labels)
        _, opt_state, metrics = apply_updates(named, grads, opt_state,
                                              tcfg.opt)
        metrics.update(loss=loss, accuracy=acc)
        return params, opt_state, metrics

    return step


def read_metrics(metrics: dict) -> dict:
    """A step's metrics as host floats, its 0-d tensors read in one
    device-to-host copy (one sync per step, however many metrics)."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = dict(metrics)
    out.update(zip(keys, torch.stack([metrics[k].float() for k in keys])
                   .tolist()))
    return out


# ---------------------------------------------------------------------------
# session-owned trainer
# ---------------------------------------------------------------------------

class PointCloudTrainer:
    """Training loop bound to a :class:`~repro_torch.serve.SpiraSession` —
    built by ``session.compile_train(...)``.

    The trainer owns the optimizer state and updates the session's
    parameters in place on every :meth:`step`, so the session serves the
    trained weights at once. Inputs are bucketed with the session's pow2
    policy (labels padded with the ignore label); ``compile_count`` is the
    number of distinct buckets seen, as inference's."""

    def __init__(self, session, tcfg: Optional[PointCloudTrainConfig] = None,
                 *, opt_state: Optional[OptState] = None):
        self.session = session
        self.metrics = (getattr(session, "metrics", None)
                        or MetricsRegistry())
        self.tcfg = tcfg or PointCloudTrainConfig()
        self.opt_state = opt_state if opt_state is not None else \
            init_opt_state(dict(session.params.named_parameters()),
                           self.tcfg.opt)
        self._step = make_pointcloud_train_step(
            session.net, session.layout, self.tcfg, engine=session.engine,
            downsample_method=session.downsample_method,
            segment=session.segment)
        self._buckets: set = set()

    def _prepare(self, st: SparseTensor, labels
                 ) -> Tuple[SparseTensor, torch.Tensor]:
        """Validate and bucket one labeled batch: pad the tensor to the
        session's pow2 capacity bucket and the labels with the ignore
        label, both on the session's device."""
        ensure_sparse_tensor(st, where="PointCloudTrainer.step")
        if st.layout != self.session.layout:
            raise ValueError(
                f"SparseTensor layout {st.layout} != session layout "
                f"{self.session.layout} — build training batches against "
                "session.layout (train.pointcloud.labeled_batch(batch, "
                "session.layout)).")
        dev = self.session.device
        labels = torch.as_tensor(labels, device=dev).to(torch.int32)
        if labels.shape[0] != st.capacity:
            raise ValueError(
                f"labels rows ({labels.shape[0]}) != SparseTensor capacity "
                f"({st.capacity}) — use train.pointcloud.labeled_tensor / "
                "labeled_batch, which keep them aligned through sort/dedup.")
        cap = self.session._bucket(st.capacity)
        stp = st.to(dev).pad_to(cap)
        if cap != labels.shape[0]:
            labels = torch.cat([labels, torch.full(
                (cap - labels.shape[0],), self.tcfg.ignore_label,
                dtype=torch.int32, device=dev)])
        return stp, labels

    def step(self, st: SparseTensor, labels) -> dict:
        """One optimization step on a (batched) labeled SparseTensor.
        Returns float metrics; updates ``session.params`` and
        ``opt_state`` in place."""
        with span("train/pack", self.metrics):
            stp, labels = self._prepare(st, labels)
        self._buckets.add(stp.capacity)
        # the span ends after the metrics' read, which waits for the device
        with span("train/step", self.metrics):
            _, self.opt_state, metrics = self._step(
                self.session.params, self.opt_state, stp.packed,
                stp.features, labels)
            out = read_metrics(metrics)
        return out

    @property
    def compile_count(self) -> int:
        """Distinct capacity buckets trained on so far."""
        return len(self._buckets)

    def __repr__(self):
        return (f"PointCloudTrainer({self.session.net.name}, "
                f"step={self.opt_state.step}, "
                f"buckets={self.compile_count})")
