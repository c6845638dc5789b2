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
(per layer the OS and/or WS kernel as its dataflow says, the segment-sum
kernel per BN). ``compile_count``
counts the distinct (bucket, escalation) keys run so far, the counterpart
of the reference's one jitted executable per key; capturing a CUDA graph
per bucket is later work (ROADMAP Queue 1).
:meth:`SpiraSession.compile_train` returns the trainer that updates the
session's parameters in place (``train.pointcloud``).

A batch of B scenes is bitwise equal to B single-scene calls: the batch
field is the packed word's most-significant field, so scenes stay
contiguous at every level and kernel maps never cross scenes, and every
per-row computation on the path adds in an order that does not depend on
the row's position or the bucket (``models.pointcloud`` module doc).

Tuning (Spira §5.4): ``compile_network(tuner=..., tune_sample=...)``
tunes every layer once, before serving, and persists the tuned specs on
``session.net``; ``session.tune_report`` keeps the raw results, the
windows held to the search kernel's largest and the seconds the tuning
took. On the card a tuned layer always runs the kernels
(``backend="cuda"``): the plain versions are never timed or chosen there.

Overflow escalation: WS/hybrid layers with a tuned ``ws_capacity`` drop
pairs beyond it. Each call counts the pairs its plan drops; when nonzero
the session replans at the next escalation level (bucket and every
``ws_capacity`` doubled) up to ``max_overflow_replans`` times, instead of
serving truncated logits. Lossy capacity is not batch-invariant (the first
``ws_capacity`` rows of a column survive across the whole batch), but once
escalation has removed every drop the logits on real rows are bitwise those
of a lossless run: every kernel on the path is zero-extension invariant.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from ..core.kernel_map import l1_partition
from ..core.network_plan import NetworkPlan, build_network_plan
from ..core.packing import BitLayout
from ..core.sparse_tensor import SparseTensor, ensure_sparse_tensor
from ..core.spconv import SpConvSpec
from ..core.tuner import (H100_COSTS, CostConstants, LayerTuneResult,
                          SegmentTuneResult, apply_tuning, device_backends,
                          tune_layer_cost_model, tune_layer_measure,
                          tune_segment_backend_measure)
from ..core.zdelta import symmetry_anchor_count, zdelta_offsets
from ..kernels.segsum import SegmentSpec
from ..kernels.zdelta_window import max_window
from ..models.pointcloud import (PointCloudModel, PointCloudNet,
                                 init_pointcloud, packed_segments,
                                 pointcloud_forward)
from ..obs import MetricsRegistry, span
from .bucketing import bucket_capacity

TunerArg = Union[None, str, Mapping[str, LayerTuneResult]]


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
class TuneReport:
    """What ``compile_network(tuner=...)`` did: ``mode`` ("cost_model",
    "measure" or "mapping"), the raw per-layer ``results`` (a mapping that
    ``tuner=`` takes back), the layers whose planned window exceeded what
    the search kernel can stage (``{layer: (planned W, W used)}``; the
    per-cell repair keeps their maps exact), the segment engine's result
    (measure mode) and the seconds the tuning took."""

    mode: str
    results: Dict[str, LayerTuneResult]
    windows_limited: Dict[str, Tuple[int, int]]
    segment: Optional[SegmentTuneResult]
    seconds: float


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
    tune_report: Optional[TuneReport] = None

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
        # per lossy WS layer the pairs beyond capacity, stacked on the card
        # and read with one sync
        names, dropped = [], []
        for s in specs:
            if not s.ws_capacity or s.dataflow not in ("ws", "hybrid"):
                continue
            pairs = (plan.kmaps[s.name].m >= 0).sum(dim=0)
            if s.dataflow == "hybrid":
                _, cols = l1_partition(s.K, s.offset_stride, s.t)
                if cols.size == 0:
                    continue
                pairs = pairs[torch.as_tensor(cols, device=pairs.device)
                              .long()]
            names.append(s.name)
            dropped.append((pairs - s.ws_capacity).clamp(min=0).sum())
        drops = (dict(zip(names, torch.stack(dropped).tolist()))
                 if names else {})
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

    def compile_train(self, tcfg=None, *, opt_state=None, guard=None,
                      ckpt=None, resume: bool = False):
        """Training entry point: a
        :class:`~repro_torch.train.PointCloudTrainer` bound to this
        session. Each ``trainer.step(st, labels)`` pads the batch to the
        session's bucket, builds the plan once (no autograd), runs forward,
        masked cross-entropy, the transposed-map backward and AdamW, and
        updates ``self.params`` in place, so the session serves the trained
        weights at once. The backward adds no kernel-map search.

        ``guard`` / ``ckpt`` / ``resume`` (the reference's self-healing
        trainer and checkpoints) are not ported yet and raise."""
        if guard is not None or ckpt is not None or resume:
            raise NotImplementedError(
                "compile_train(guard=/ckpt=/resume=) is not ported yet "
                "(ROADMAP Queue 1, item 3: train/guard.py, ckpt/manager.py)")
        from ..train.pointcloud import PointCloudTrainer
        return PointCloudTrainer(self, tcfg, opt_state=opt_state)

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
    tuner: TunerArg = None,
    tune_sample: Optional[SparseTensor] = None,
    tune_costs: CostConstants = H100_COSTS,
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
    * ``engine`` — ``"zdelta_cuda"`` (superwindow search kernel),
      ``"zdelta_cuda_window"`` (per-group window search kernel),
      ``"zdelta"`` (the search in torch), or the paper's baselines
      ``"bsearch"`` and ``"hash"`` (``core.network_plan``).
    * ``tuner`` — the one-time §5.4 tuning, before serving:
        - ``None``: the specs as written;
        - ``"cost_model"``: the analytic (t, backend, symmetry) choice per
          layer from the sample plan's kernel-map statistics, weighted by
          ``tune_costs`` (default the H100's; ``core.tuner``);
        - ``"measure"``: a wall-clock sweep of t per layer on this device,
          the exact window from the sample's coordinates and, for
          submanifold layers, the half-search timed on ``engine``'s own
          search; also the segment engine's backend;
        - a mapping ``{layer: LayerTuneResult}`` of earlier results (e.g.
          ``session.tune_report.results``).
      ``tune_sample`` (a :class:`SparseTensor`) is the sample the first
      two build their plan from. The backend axis is the device's own
      (``"cuda"`` on the card, ``"torch"`` on the CPU); a window above the
      search kernel's largest for the word type is held to it. The tuned
      specs live on ``session.net``, the raw results on
      ``session.tune_report``.
    * ``segment_backend`` — backend of the BN segment sums.
    """
    if (1 << layout.bb) < batch:
        layout = layout.with_batch(batch)
    if params is None:
        params = init_pointcloud(net, seed=seed, device=device, dtype=dtype)
    seg_spec = SegmentSpec(backend=segment_backend)
    report = None
    if tuner is not None:
        tic = time.perf_counter()
        specs, results = _tune_specs(
            net, layout, params, tuner, tune_sample, engine=engine,
            downsample_method=downsample_method, min_bucket=min_bucket,
            costs=tune_costs, device=device)
        specs, limited = _limit_windows(specs, engine, layout)
        net = dataclasses.replace(net, specs=specs)
        seg_res = None
        if tuner == "measure":
            seg_res = _tune_segment(seg_spec, tune_sample,
                                    min_bucket=min_bucket, device=device)
            seg_spec = dataclasses.replace(seg_spec, backend=seg_res.backend)
        report = TuneReport(
            mode=tuner if isinstance(tuner, str) else "mapping",
            results=results, windows_limited=limited, segment=seg_res,
            seconds=time.perf_counter() - tic)
    session = SpiraSession(net=net, layout=layout, params=params,
                           engine=engine,
                           downsample_method=downsample_method,
                           min_bucket=min_bucket, max_bucket=max_bucket,
                           segment=seg_spec,
                           max_overflow_replans=max_overflow_replans,
                           metrics=metrics, device=device,
                           tune_report=report)
    if report is not None:
        session.metrics.gauge("tuner_windows_limited").set(
            len(report.windows_limited))
    return session


def _tune_segment(seg_spec: SegmentSpec, tune_sample: SparseTensor, *,
                  min_bucket: int, device) -> SegmentTuneResult:
    """Time the segment engine on the sample's V0 segmentation (step-time
    objective), on the device's own backend."""
    st = tune_sample.to(device)
    stp = st.pad_to(bucket_capacity(st.capacity, min_bucket=min_bucket))
    seg = packed_segments(stp.packed, stp.count, stp.layout)
    return tune_segment_backend_measure(stp.features, seg, q=seg_spec.q)


def _tune_specs(net: PointCloudNet, layout: BitLayout,
                params: PointCloudModel, tuner: TunerArg,
                tune_sample: Optional[SparseTensor], *, engine: str,
                downsample_method: str, min_bucket: int,
                costs: CostConstants, device
                ) -> Tuple[Tuple[SpConvSpec, ...], Dict[str, LayerTuneResult]]:
    """Resolve ``tuner`` into tuned specs and the raw results by layer
    (see compile_network)."""
    if isinstance(tuner, Mapping):
        results = {s.name: tuner[s.name] for s in net.specs
                   if s.name in tuner}
        return tuple(apply_tuning(s, results[s.name]) if s.name in results
                     else s for s in net.specs), results
    if tuner not in ("cost_model", "measure"):
        raise ValueError(f"tuner must be None, 'cost_model', 'measure' or a "
                         f"{{layer: LayerTuneResult}} mapping, got {tuner!r}")
    if tune_sample is None:
        raise ValueError(f"tuner={tuner!r} needs tune_sample= (a "
                         "representative SparseTensor) to build the sample "
                         "plan it tunes against")
    ensure_sparse_tensor(tune_sample, where="compile_network(tune_sample=)")
    st = tune_sample.to(device)
    stp = st.pad_to(bucket_capacity(st.capacity, min_bucket=min_bucket))
    with torch.no_grad():
        plan = build_network_plan(stp.packed, specs=net.conv_specs(),
                                  layout=layout, engine=engine,
                                  downsample_method=downsample_method)
    backends = device_backends(stp.packed)
    itemsize = torch.finfo(params.head.dtype).bits // 8
    results = {}
    for s in net.specs:
        kmap = plan.kmaps[s.name]
        if tuner == "cost_model":
            res = tune_layer_cost_model(
                kmap, K=s.K, stride=s.offset_stride, cin=s.cin, cout=s.cout,
                itemsize=itemsize, backends=backends,
                submanifold=s.submanifold, **dataclasses.asdict(costs))
        else:
            # features from a generator seeded by a stable function of the
            # layer's name (Python's hash is salted per process)
            gen = torch.Generator().manual_seed(zlib.crc32(s.name.encode()))
            feats = torch.randn((plan.coords[s.m_in].capacity, s.cin),
                                generator=gen).to(
                device=stp.packed.device, dtype=params.head.dtype)
            _, anchors, zstep = zdelta_offsets(s.K, s.offset_stride, layout,
                                               device=stp.packed.device)
            coords = (plan.coords[s.m_in], plan.coords[s.m_out], anchors,
                      zstep)
            res = tune_layer_measure(
                feats, kmap, params.layers[s.name].weight.detach(), K=s.K,
                stride=s.offset_stride, ws_capacity=kmap.m.shape[0],
                backends=backends, coords=coords,
                submanifold=s.submanifold, engine=engine)
        results[s.name] = res
    return tuple(apply_tuning(s, results[s.name]) for s in net.specs), results


def _limit_windows(specs: Tuple[SpConvSpec, ...], engine: str,
                   layout: BitLayout):
    """Hold every spec's window to the largest its engine's search kernel
    can stage for the layout's words; returns the specs and
    ``{layer: (planned W, W used)}`` of those held."""
    if engine not in ("zdelta_cuda", "zdelta_cuda_window"):
        return specs, {}
    kind = "superwindow" if engine == "zdelta_cuda" else "window"
    out, limited = [], {}
    for s in specs:
        sym = s.symmetry and s.submanifold and engine == "zdelta_cuda"
        G = symmetry_anchor_count(s.K) if sym else s.K * s.K
        cap = max_window(kind, layout.dtype, G, s.K)
        if s.window > cap:
            limited[s.name] = (s.window, cap)
            s = dataclasses.replace(s, window=cap)
        out.append(s)
    return tuple(out), limited
