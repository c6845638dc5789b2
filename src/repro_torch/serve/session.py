"""SpiraSession: one front door from raw points to logits (torch port of
``repro.serve.session``).

A session owns capacity bucketing, network-wide plan building and the
feature pass; the hot path is one call::

    session = compile_network(net, layout, batch=2)            # on "cuda"
    out = session(SparseTensor.from_point_clouds(clouds, session.layout))
    per_scene = out.unbatch()

Each call pads its input to a power-of-two capacity bucket, builds the
plan (default engine ``"zdelta_cuda"``, so the superwindow search kernel
runs on the card, and its overflow repair too) and runs the forward pass
(per layer the OS and/or WS kernel as its dataflow says, the segment-sum
kernel per BN).

One CUDA graph per key, the counterpart of the reference's one jitted
executable per (capacity bucket, escalation level): on a ``"cuda"``
session the first call of a key copies its input into static buffers,
runs the plan+forward body once on a side stream (warm-up: the kernel
library's build, shared-memory attributes, cuBLAS handles and every
device constant the body reads) and captures it; every call of the key,
that one included, copies its input into the buffers, replays the graph,
reads the stacked health counters once and clones the logits, words and
count out of the graph's memory. The body makes no host read, has no host
branch on data and copies nothing from the host, so the capture holds the
whole call. ``compile_count`` is the number of graphs captured (one per
key, as the reference's jit cache). ``cuda_graphs=False`` runs every call
eagerly (the counterpart of ``jax.disable_jit()``: each launch then goes
through its Python wrapper, where a launch count can see it); a ``"cpu"``
session always does. There is no fallback: a capture or replay that
fails raises.

The graphs of one session share one memory pool. That is safe in any
replay order because a call holds the session's lock from its input copy
to its clones: the only memory of one graph that outlives its replay is
its outputs, copied out before any other graph of the session replays,
and the static inputs live outside the pool. A graph reads the parameters
at their addresses, so updates must be in place (the trainers'
``copy_``, checkpoint restore); assigning ``session.params`` drops every
graph. A capture abandoned by the serving engine's watchdog finishes under
the lock, and a key enters the session only once its capture succeeded.
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

Observability (``repro_torch.obs``): a call records its stages as spans
in ``session.metrics`` — ``session/admit``, ``session/call`` with
``load`` / ``capture`` / ``replay`` / ``read`` inside, ``session/health``
and ``session/finish`` (:meth:`SpiraSession.run_with_health`) — which are
also ranges on a ``torch.profiler`` timeline while one records. Counters
sum the runs, replans, graph captures and replays, dropped pairs and
overflowed window cells; ``session.last_health`` keeps the last call's
counts by layer.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from ..core.kernel_map import l1_partition
from ..core.network_plan import NetworkPlan, build_network_plan
from ..core.packing import BitLayout, device_constant
from ..core.sparse_tensor import SparseTensor, ensure_sparse_tensor
from ..core.spconv import SpConvSpec
from ..core.tuner import (H100_COSTS, CostConstants, LayerTuneResult,
                          SegmentTuneResult, apply_tuning, device_backends,
                          tune_layer_cost_model, tune_layer_measure,
                          tune_segment_backend_measure)
from ..core.voxel import pad_value
from ..core.zdelta import symmetry_anchor_count, zdelta_offsets
from ..kernels.segsum import SegmentSpec
from ..kernels.zdelta_window import max_window
from ..models.pointcloud import (PointCloudModel, PointCloudNet,
                                 init_pointcloud, packed_segments,
                                 pointcloud_forward)
from ..obs import MetricsRegistry, span
from .bucketing import bucket_capacity
from .graphs import capture

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
class _KeyGraph:
    """One key's CUDA graph, its static input buffers (allocated outside
    the graph's memory pool) and the body's outputs (inside it): logits,
    output words, output count, stacked counters."""

    graph: Optional["torch.cuda.CUDAGraph"]
    packed: torch.Tensor
    features: torch.Tensor
    outputs: Tuple[torch.Tensor, ...] = ()


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
    cuda_graphs: bool = True

    def __post_init__(self):
        if self.metrics is None:
            self.metrics = MetricsRegistry()
        self.device = torch.device(self.device)
        if self._graphs and self.engine == "hash":
            raise ValueError("engine 'hash' probes in a host loop that ends "
                             "on the data, which a CUDA graph cannot "
                             "capture; pass cuda_graphs=False")
        self.params = self.params.to(self.device)
        self._lock = threading.Lock()
        self._drop_keys()
        self.last_health: Optional[HealthReport] = None

    def __setattr__(self, name, value):
        # a graph reads the parameters at their addresses: new tensors drop
        # every key (the trainers' in-place updates keep them)
        if name == "params" and "_keys" in self.__dict__:
            self._drop_keys()
        super().__setattr__(name, value)

    def _drop_keys(self) -> None:
        # key (bucket, escalation, features dtype) -> its graph, or None
        # where the session runs eagerly
        self._keys: Dict[tuple, Optional[_KeyGraph]] = {}
        self._pool = None

    @property
    def _graphs(self) -> bool:
        return self.cuda_graphs and self.device.type == "cuda"

    def _escalated_net(self, esc: int) -> PointCloudNet:
        """The network with every lossy ``ws_capacity`` scaled ``2^esc``."""
        if esc == 0:
            return self.net
        specs = tuple(
            dataclasses.replace(s, ws_capacity=s.ws_capacity << esc)
            if (s.ws_capacity and s.dataflow in ("ws", "hybrid")) else s
            for s in self.net.conv_specs())
        return dataclasses.replace(self.net, specs=specs)

    @staticmethod
    def _lossy(specs) -> list:
        """``(name, capacity, sparse columns or None)`` of every layer that
        can drop WS pairs: WS or hybrid with a ``ws_capacity``; of a hybrid
        layer only its sparse (WS) columns, and none when it has none."""
        out = []
        for s in specs:
            if not s.ws_capacity or s.dataflow not in ("ws", "hybrid"):
                continue
            cols = None
            if s.dataflow == "hybrid":
                _, cols = l1_partition(s.K, s.offset_stride, s.t)
                if cols.size == 0:
                    continue
            out.append((s.name, s.ws_capacity, cols))
        return out

    def _body(self, esc: int, packed: torch.Tensor, feats: torch.Tensor):
        """Plan + forward at one escalation level: the logits, the output
        level's words and count, and one int64 tensor stacking every lossy
        layer's dropped pairs, then every layer's overflowed window cells
        (:meth:`_health_counters` names them). No host read, no host
        branch on data, no host-to-device copy: what a graph captures."""
        net = self._escalated_net(esc)
        specs = net.conv_specs()
        plan = build_network_plan(packed, specs=specs, layout=self.layout,
                                  engine=self.engine,
                                  downsample_method=self.downsample_method)
        logits = pointcloud_forward(self.params, net, plan, feats,
                                    layout=self.layout, segment=self.segment)
        out = plan.coords[specs[-1].m_out]
        counters = []
        for name, cap, cols in self._lossy(specs):
            pairs = (plan.kmaps[name].m >= 0).sum(dim=0)
            if cols is not None:
                pairs = pairs[device_constant(cols, torch.long,
                                              pairs.device)]
            counters.append((pairs - cap).clamp(min=0).sum())
        counters += [plan.stats[s.name].to(torch.int64) for s in specs]
        return logits, out.packed, out.count, torch.stack(counters)

    def _health_counters(self, esc: int, values: list):
        """The body's counters, read to the host, as ``(dropped pairs by
        lossy layer, overflowed cells by layer)``."""
        specs = self._escalated_net(esc).conv_specs()
        names = [name for name, _, _ in self._lossy(specs)]
        return (dict(zip(names, values[:len(names)])),
                dict(zip([s.name for s in specs], values[len(names):])))

    def _load(self, g: _KeyGraph, st: SparseTensor) -> None:
        """Copy ``st`` into a key's static buffers, PAD words and zero
        features past its rows (what ``pad_to`` gives)."""
        cap = st.capacity
        g.packed[:cap].copy_(st.packed)
        g.packed[cap:].fill_(pad_value(g.packed.dtype))
        g.features[:cap].copy_(st.features)
        g.features[cap:].zero_()

    def _capture(self, key: tuple, esc: int, st: SparseTensor) -> _KeyGraph:
        """Warm up and capture one key's graph with ``st`` loaded
        (``serve.graphs.capture``); the key enters the session only if the
        capture succeeds. A gauge keeps the memory reserved after the last
        capture; the ``session/call/capture`` span its seconds."""
        bucket, dev = key[0], self.device
        reg = self.metrics
        g = _KeyGraph(None,
                      torch.empty((bucket,), dtype=st.packed.dtype,
                                  device=dev),
                      torch.empty((bucket, st.channels),
                                  dtype=st.features.dtype, device=dev))
        self._load(g, st)
        g.graph, g.outputs = capture(
            lambda: self._body(esc, g.packed, g.features), dev,
            pool=self._pool)
        if self._pool is None:
            self._pool = g.graph.pool()
        self._keys[key] = g
        reg.counter("session_graph_captures").inc()
        reg.gauge("session_graph_memory_reserved").set(
            torch.cuda.memory_reserved(dev))
        return g

    def _run(self, bucket: int, esc: int, st: SparseTensor):
        """One key on ``st`` (already on the device when eager): the
        outputs (logits, words, count; a graph's own buffers when
        replayed) and the counters, read to the host once. Runs inside the
        call's span, under which it records the stages ``load`` (the input
        into the key's buffers, or padded to the bucket when eager),
        ``capture`` (a key's first call on a graph session: load,
        warm-up and capture), ``replay`` (the graph, or the eager body) and
        ``read`` (the counters' copy, where the host waits for the
        device)."""
        key = (bucket, esc, st.features.dtype)
        reg = self.metrics
        if not self._graphs:
            self._keys.setdefault(key, None)
            with span("load", reg):
                stp = st.pad_to(bucket)
            with span("replay", reg):
                *outs, counters = self._body(esc, stp.packed, stp.features)
            with span("read", reg):
                return outs, counters.tolist()
        g = self._keys.get(key)
        if g is None:
            with span("capture", reg):
                g = self._capture(key, esc, st)
        else:
            with span("load", reg):
                self._load(g, st)
        with span("replay", reg):
            g.graph.replay()
        reg.counter("session_graph_replays").inc()
        with span("read", reg):
            return g.outputs[:3], g.outputs[3].tolist()

    # -- hot path ---------------------------------------------------------

    def __call__(self, st: SparseTensor) -> SparseTensor:
        return self.run_with_health(st)[0]

    @torch.no_grad()
    def run_with_health(self, st: SparseTensor, *,
                        max_replans: Optional[int] = None
                        ) -> Tuple[SparseTensor, HealthReport]:
        """Run with the escalation loop (module doc); returns
        ``(logits, health)``. ``max_replans`` can only tighten the
        session's ``max_overflow_replans``.

        Spans, in order: ``session/admit`` (validation, the eager
        session's one copy of the input to the device, bucketing, the
        session's lock), per escalation level ``session/call`` (level 0)
        or ``session/replan`` with :meth:`_run`'s stages inside, and
        ``session/health`` (the counters by layer), then
        ``session/finish`` (the clones out of the graph's memory, the
        health report, its registry entries, the output tensor)."""
        reg = self.metrics
        with contextlib.ExitStack() as held:
            with span("session/admit", reg):
                ensure_sparse_tensor(st, where="SpiraSession")
                if st.layout != self.layout:
                    raise ValueError(
                        f"SparseTensor layout {st.layout} != session layout "
                        f"{self.layout}; build inputs against "
                        "session.layout")
                if st.channels != self.net.in_channels:
                    raise ValueError(
                        f"SparseTensor has {st.channels} feature channels; "
                        f"{self.net.name} expects {self.net.in_channels}.")
                if not self._graphs:
                    st = st.to(self.device)
                base = self._bucket(st.capacity)
                budget = (self.max_overflow_replans if max_replans is None
                          else min(max_replans, self.max_overflow_replans))
                held.enter_context(self._lock)
            esc = replans = 0
            while True:
                bucket = self._esc_bucket(base, esc)
                with span("session/call" if esc == 0 else "session/replan",
                          reg):
                    outs, counters = self._run(bucket, esc, st)
                with span("session/health", reg):
                    dropped, ovf = self._health_counters(esc, counters)
                if sum(dropped.values()) == 0 or esc >= budget:
                    break
                esc += 1
                replans += 1
            with span("session/finish", reg):
                if self._graphs:
                    outs = [t.clone() for t in outs]
                logits, out_packed, out_count = outs
                health = HealthReport(
                    bucket=bucket, escalation=esc, replans=replans,
                    ws_dropped_pairs=dropped, window_overflow_cells=ovf)
                self.last_health = health
                self._record_health(health)
                out = SparseTensor(features=logits, packed=out_packed,
                                   count=out_count, layout=self.layout)
        return out, health

    def _record_health(self, health: HealthReport) -> None:
        """Fold one call's HealthReport into the registry: the runs and
        replans, the bucket and escalation level, and the dropped pairs
        and overflowed window cells summed over the layers and the calls
        (``last_health`` keeps them by layer)."""
        reg = self.metrics
        reg.counter("session_runs").inc()
        if health.replans:
            reg.counter("session_replans").inc(health.replans)
        reg.gauge("session_bucket").set(health.bucket)
        reg.gauge("session_escalation").set(health.escalation)
        reg.counter("session_ws_dropped_pairs").inc(health.total_ws_dropped)
        reg.counter("plan_window_overflow_cells").inc(
            sum(health.window_overflow_cells.values()))

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

        Any of ``guard`` / ``ckpt`` / ``resume`` upgrades the result to a
        :class:`~repro_torch.train.GuardedPointCloudTrainer`, the
        self-healing trainer (``train.guard`` module doc): non-finite skip,
        loss-spike skip, per-scene bisection quarantine, checkpoint
        rollback, typed abort.

        * ``guard`` — a :class:`~repro_torch.train.GuardConfig`, or
          ``True`` for the defaults.
        * ``ckpt`` — a :class:`~repro_torch.ckpt.CheckpointManager` or a
          directory path; enables the auto-checkpoint cadence
          (``GuardConfig.ckpt_every``), the ``last_good`` rollback anchor
          and crash-safe resume.
        * ``resume=True`` — restore the newest *verifying* checkpoint from
          ``ckpt`` before the first step (torn or corrupt checkpoints are
          walked past).
        """
        if guard is None and ckpt is None and not resume:
            from ..train.pointcloud import PointCloudTrainer
            return PointCloudTrainer(self, tcfg, opt_state=opt_state)
        from ..train.guard import GuardConfig, GuardedPointCloudTrainer
        if guard is True:
            guard = GuardConfig()
        if resume and ckpt is None:
            raise ValueError("compile_train(resume=True) needs ckpt= (a "
                             "CheckpointManager or directory) to resume "
                             "from")
        return GuardedPointCloudTrainer(self, tcfg, guard=guard, ckpt=ckpt,
                                        opt_state=opt_state, resume=resume)

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
        """Keys run so far, one per (capacity bucket, escalation level) as
        the reference's compiled executables: on a graph session the graphs
        captured. Without overflow traffic, one per bucket."""
        return len(self._keys)

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
    cuda_graphs: bool = True,
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
    * ``cuda_graphs`` — on the card, one CUDA graph per key (module doc);
      False runs every call eagerly. A CPU session always runs eagerly.
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
                           tune_report=report, cuda_graphs=cuda_graphs)
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
