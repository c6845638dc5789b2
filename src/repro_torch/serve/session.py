"""SpiraSession: one front door from raw points to logits (torch port of
``repro.serve.session``).

A session owns capacity bucketing, network-wide plan building and the
feature pass; the hot path is one call::

    session = compile_network(net, layout, batch=2)            # on "cuda"
    out = session(SparseTensor.from_point_clouds(clouds, session.layout))
    per_scene = out.unbatch()

The session runs eagerly: each call pads its input to a power-of-two
capacity bucket, builds the plan (default engine ``"zdelta_cuda"``, so the
superwindow search kernel runs on the card) and runs the forward pass
(the OS kernel per layer, the segment-sum kernel per BN). ``compile_count``
counts the distinct (bucket, escalation) keys run so far, the counterpart
of the reference's one jitted executable per key; capturing a CUDA graph
per bucket is later work (ROADMAP Queue 1).

A batch of B scenes is bitwise equal to B single-scene calls: the batch
field is the packed word's most-significant field, so scenes stay
contiguous at every level and kernel maps never cross scenes, and every
per-row computation on the path adds in an order that does not depend on
the row's position or the bucket (``models.pointcloud`` module doc).

Overflow escalation: WS/hybrid layers with a tuned ``ws_capacity`` drop
pairs beyond it. Each call counts the pairs its plan would drop; when
nonzero the session replans at the next escalation level (bucket and every
``ws_capacity`` doubled) up to ``max_overflow_replans`` times. The port's
layers are OS only for now (WS raises, ROADMAP Queue 2), so the loop runs
once, but it and :class:`HealthReport` keep the reference's contract.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core.kernel_map import l1_partition
from ..core.network_plan import NetworkPlan, build_network_plan
from ..core.packing import BitLayout
from ..core.sparse_tensor import SparseTensor, ensure_sparse_tensor
from ..kernels.segsum import SegmentSpec
from ..models.pointcloud import (PointCloudModel, PointCloudNet,
                                 init_pointcloud, pointcloud_forward)
from ..obs import MetricsRegistry, span
from .bucketing import bucket_capacity


@dataclasses.dataclass
class HealthReport:
    """Per-call degradation accounting (``SpiraSession.run_with_health``):
    ``ws_dropped_pairs`` all zero means every pair of the lossless map was
    computed; ``window_overflow_cells`` is a perf signal only (overflowed
    superwindow cells are repaired exactly)."""

    bucket: int
    escalation: int
    replans: int
    ws_dropped_pairs: Dict[str, int]
    window_overflow_cells: Dict[str, int]

    @property
    def total_ws_dropped(self) -> int:
        return sum(self.ws_dropped_pairs.values())

    @property
    def ok(self) -> bool:
        return self.total_ws_dropped == 0

    def summary(self) -> str:
        worst = sorted(self.ws_dropped_pairs.items(), key=lambda kv: -kv[1])
        worst = [f"{k}:{v}" for k, v in worst if v][:3]
        return (f"bucket={self.bucket} escalation={self.escalation} "
                f"replans={self.replans} "
                f"ws_dropped={self.total_ws_dropped}"
                f"{' (' + ', '.join(worst) + ')' if worst else ''} "
                f"window_overflows="
                f"{sum(self.window_overflow_cells.values())}")


@dataclasses.dataclass
class SpiraSession:
    """Point-cloud pipeline ``session(st) -> st`` of logits on the net's
    output-level coordinates. Built by :func:`compile_network`."""

    net: PointCloudNet
    layout: BitLayout
    params: PointCloudModel
    engine: str = "zdelta_cuda"
    downsample_method: str = "auto"
    min_bucket: int = 1024
    max_bucket: Optional[int] = None
    segment: SegmentSpec = SegmentSpec()
    max_overflow_replans: int = 2
    metrics: Optional[MetricsRegistry] = None
    device: torch.device | str = "cuda"

    def __post_init__(self):
        if self.metrics is None:
            self.metrics = MetricsRegistry()
        self.device = torch.device(self.device)
        self.params = self.params.to(self.device)
        self._keys_run: set = set()
        self.last_health: Optional[HealthReport] = None

    def _escalated_net(self, esc: int) -> PointCloudNet:
        """The network with every lossy ``ws_capacity`` scaled ``2^esc``."""
        if esc == 0:
            return self.net
        specs = tuple(
            dataclasses.replace(s, ws_capacity=s.ws_capacity << esc)
            if (s.ws_capacity and s.dataflow in ("ws", "hybrid")) else s
            for s in self.net.conv_specs())
        return dataclasses.replace(self.net, specs=specs)

    def _run(self, esc: int, packed: torch.Tensor, feats: torch.Tensor):
        """Plan + forward at one escalation level; returns the logits, the
        output level's coordinates and the health counters."""
        net = self._escalated_net(esc)
        specs = net.conv_specs()
        plan = build_network_plan(packed, specs=specs, layout=self.layout,
                                  engine=self.engine,
                                  downsample_method=self.downsample_method)
        logits = pointcloud_forward(self.params, net, plan, feats,
                                    layout=self.layout, segment=self.segment)
        out = plan.coords[specs[-1].m_out]
        drops = {}
        for s in specs:
            if not s.ws_capacity or s.dataflow not in ("ws", "hybrid"):
                continue
            m = plan.kmaps[s.name].m
            if s.dataflow == "hybrid":
                _, cols = l1_partition(s.K, s.offset_stride, s.t)
                if cols.size == 0:
                    continue
                m = m[:, torch.as_tensor(cols, device=m.device).long()]
            pairs = (m >= 0).sum(dim=0)
            drops[s.name] = int((pairs - s.ws_capacity).clamp(min=0).sum())
        return logits, out.packed, out.count, drops, plan.stats

    # -- hot path ---------------------------------------------------------

    def __call__(self, st: SparseTensor) -> SparseTensor:
        return self.run_with_health(st)[0]

    @torch.no_grad()
    def run_with_health(self, st: SparseTensor, *,
                        max_replans: Optional[int] = None
                        ) -> Tuple[SparseTensor, HealthReport]:
        """Run with the escalation loop (module doc); returns
        ``(logits, health)``. ``max_replans`` can only tighten the
        session's ``max_overflow_replans``."""
        ensure_sparse_tensor(st, where="SpiraSession")
        if st.layout != self.layout:
            raise ValueError(
                f"SparseTensor layout {st.layout} != session layout "
                f"{self.layout}; build inputs against session.layout")
        if st.channels != self.net.in_channels:
            raise ValueError(
                f"SparseTensor has {st.channels} feature channels; "
                f"{self.net.name} expects {self.net.in_channels}.")
        st = st.to(self.device)
        base = self._bucket(st.capacity)
        budget = (self.max_overflow_replans if max_replans is None
                  else min(max_replans, self.max_overflow_replans))
        esc = replans = 0
        while True:
            bucket = self._esc_bucket(base, esc)
            stp = st.pad_to(bucket)
            self._keys_run.add((bucket, esc))
            with span("session/call" if esc == 0 else "session/replan",
                      self.metrics):
                logits, out_packed, out_count, dropped, ovf = self._run(
                    esc, stp.packed, stp.features)
            if sum(dropped.values()) == 0 or esc >= budget:
                break
            esc += 1
            replans += 1
        health = HealthReport(
            bucket=bucket, escalation=esc, replans=replans,
            ws_dropped_pairs=dropped,
            window_overflow_cells={k: int(v) for k, v in ovf.items()})
        self.last_health = health
        self._record_health(health)
        out = SparseTensor(features=logits, packed=out_packed,
                           count=out_count, layout=self.layout)
        return out, health

    def _record_health(self, health: HealthReport) -> None:
        """Fold one call's HealthReport into the registry."""
        reg = self.metrics
        reg.counter("session_runs").inc()
        if health.replans:
            reg.counter("session_replans").inc(health.replans)
        reg.gauge("session_bucket").set(health.bucket)
        reg.gauge("session_escalation").set(health.escalation)
        for name, v in health.ws_dropped_pairs.items():
            reg.gauge(f"session_ws_dropped_pairs_{name}").set(v)
        for name, v in health.window_overflow_cells.items():
            reg.gauge(f"plan_window_overflow_cells_{name}").set(v)

    def _esc_bucket(self, base_bucket: int, esc: int) -> int:
        """The next pow2 bucket per escalation level, clamped to
        ``max_bucket``."""
        b = base_bucket << esc
        if self.max_bucket is not None and b > self.max_bucket:
            b = max(base_bucket, self.max_bucket)
        return b

    @torch.no_grad()
    def plan(self, st: SparseTensor) -> NetworkPlan:
        """The network plan the session would use for ``st`` (bucketed),
        for inspection and benchmarks."""
        ensure_sparse_tensor(st, where="SpiraSession.plan")
        with span("session/plan", self.metrics):
            stp = st.to(self.device).pad_to(self._bucket(st.capacity))
            return build_network_plan(
                stp.packed, specs=self.net.conv_specs(), layout=self.layout,
                engine=self.engine, downsample_method=self.downsample_method)

    def compile_train(self, *args, **kwargs):
        raise NotImplementedError(
            "training is not ported yet (ROADMAP Queue 1, item 6)")

    def _bucket(self, n: int) -> int:
        return bucket_capacity(n, min_bucket=self.min_bucket,
                               max_bucket=self.max_bucket)

    # -- facts ------------------------------------------------------------

    @property
    def num_scenes(self) -> int:
        """Scene slots per call (1 << layout.bb); any B <= this works."""
        return 1 << self.layout.bb

    @property
    def compile_count(self) -> int:
        """Distinct (capacity bucket, escalation level) keys run so far;
        without overflow traffic, one per bucket."""
        return len(self._keys_run)

    def __repr__(self):
        return (f"SpiraSession({self.net.name}, engine={self.engine!r}, "
                f"scenes<={self.num_scenes}, layout={self.layout}, "
                f"device={self.device}, buckets={self.compile_count})")


def compile_network(
    net: PointCloudNet,
    layout: BitLayout,
    *,
    params: Optional[PointCloudModel] = None,
    seed: int = 0,
    batch: int = 1,
    engine: str = "zdelta_cuda",
    downsample_method: str = "auto",
    min_bucket: int = 1024,
    max_bucket: Optional[int] = None,
    tuner: None = None,
    segment_backend: str = "auto",
    max_overflow_replans: int = 2,
    dtype=torch.float32,
    metrics: Optional[MetricsRegistry] = None,
    device="cuda",
) -> SpiraSession:
    """Build a :class:`SpiraSession` on ``device`` (the card unless the
    caller asks for "cpu").

    * ``batch`` widens the layout's batch field to hold that many scenes.
    * ``params`` — a :class:`PointCloudModel` (e.g. from
      ``convert.params_from_jax``); omitted, ``init_pointcloud(net,
      seed=seed)``.
    * ``engine`` — ``"zdelta_cuda"`` (superwindow search kernel) or
      ``"zdelta"`` (the search in torch).
    * ``segment_backend`` — backend of the BN segment sums.
    * ``tuner`` — not ported yet; anything but None raises.
    """
    if tuner is not None:
        raise NotImplementedError(
            "compile_network(tuner=...) is not ported yet (ROADMAP Queue 1, "
            "item 7); pass tuned specs in the network instead")
    if (1 << layout.bb) < batch:
        layout = layout.with_batch(batch)
    if params is None:
        params = init_pointcloud(net, seed=seed, device=device, dtype=dtype)
    return SpiraSession(net=net, layout=layout, params=params, engine=engine,
                        downsample_method=downsample_method,
                        min_bucket=min_bucket, max_bucket=max_bucket,
                        segment=SegmentSpec(backend=segment_backend),
                        max_overflow_replans=max_overflow_replans,
                        metrics=metrics, device=device)
