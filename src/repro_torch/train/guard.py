"""Self-healing training (torch port of ``repro.train.guard``): the
train-side degraded-mode contract.

One non-finite batch does not cost one answer, it corrupts
``session.params`` for every step after it. A batch fed to
:meth:`GuardedPointCloudTrainer.step` always leaves the trainer in a state
it can keep training from; no poisoned batch ever writes a non-finite value
into params or optimizer state, and every defensive decision is recorded
on a :class:`TrainHealthReport` and in
:attr:`~GuardedPointCloudTrainer.counters`. The escalation ladder:

* **Guarded step (non-finite skip).** The step computes ONE all-finite
  flag over (loss, gradient global norm) — any NaN/Inf in any gradient
  makes the global norm non-finite — and computes the AdamW update *out
  of place* (``optimizer.stage_updates``: the plain update's ops in the
  same order). The host reads the flag in the same device-to-host copy as
  the step's metrics (``pointcloud.read_metrics``: no extra sync) and
  only then commits, copying into the existing tensors; a bad step
  commits nothing, so params and optimizer state (step counter included)
  stay **bitwise unchanged**. The reference selects with ``jnp.where(ok,
  new, old)`` on the device; the port's update is in place, so the choice
  is the host's. The staged values are one extra copy of the parameters
  and both moments while a step is in flight.
* **Loss-spike skip (host-side).** Finite poison (label corruption,
  absurd-magnitude features) shows up as a loss far above the recent
  trend: :class:`LossSpikeDetector` refuses to commit a step whose loss
  exceeds ``spike_factor ×`` the median of the last ``spike_window``
  committed losses.
* **Per-scene bisection.** A refused *batched* step is retried on scene
  sub-batches (the labeled batch splits on its scene segments): halves
  re-pack and re-attempt until the poison is cornered in a single scene,
  which is quarantined while every healthy sub-batch trains. The kernels'
  batch and bucket invariance makes a sub-batch update bitwise equal to a
  clean run fed the same scenes.
* **Rollback to the last verified checkpoint.** After ``rollback_after``
  consecutive steps with nothing committable, the trainer restores the
  checkpoint manager's GC-exempt ``last_good`` tag (``ckpt.manager``
  module doc), walking back to the newest checkpoint that verifies.
* **Typed abort.** When rollback is impossible (no manager, nothing
  verifies) or has been exhausted ``max_rollbacks`` times, the trainer
  raises :class:`TrainAbortError` carrying the final report and counters.

Checkpoint cadence rides the same loop: every ``ckpt_every`` committed
steps the trainer saves (async; the host snapshot is taken before the save
returns, write errors surface on the next save), and after
``last_good_after`` further consecutive healthy steps it advances the
``last_good`` tag to that save.

The fault harness is ``train.faults``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..ckpt.manager import CheckpointError, CheckpointManager
from ..core.packing import BitLayout
from ..core.sparse_tensor import SparseTensor
from ..kernels.segsum import SegmentSpec
from ..models.pointcloud import PointCloudModel, PointCloudNet, jax_tree
from ..obs import CounterView, span
from .optimizer import AdamWConfig, OptState, stage_updates
from .pointcloud import (PointCloudTrainConfig, PointCloudTrainer,
                         labeled_tensor, make_grad_fn, read_metrics)


def checkpoint_trees(model: PointCloudModel,
                     opt_state: OptState) -> Tuple[dict, dict]:
    """The training state as the JAX package's checkpoint manager flattens
    it, with the live tensors as leaves: the parameter tree, and the AdamW
    state under the ``OptState`` fields ``.mu``, ``.nu`` (parameter-shaped
    trees) and ``.step`` (a 0-d int32). A :class:`CheckpointManager` saves
    these under the reference's keys and restores into them in place."""
    net = model.net
    return (jax_tree(dict(model.named_parameters()), net),
            {".mu": jax_tree(opt_state.mu, net),
             ".nu": jax_tree(opt_state.nu, net),
             ".step": np.asarray(opt_state.step, np.int32)})


class TrainAbortError(RuntimeError):
    """The guard's terminal escalation: training cannot proceed safely.
    Carries the final :class:`TrainHealthReport` and the counters dict."""

    def __init__(self, msg: str, *, report=None, counters=None):
        super().__init__(msg)
        self.report = report
        self.counters = counters


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Static configuration of the guarded trainer's escalation ladder."""

    # host-side loss-spike detector (module doc)
    spike_window: int = 16        # ring buffer of committed losses
    spike_factor: float = 10.0    # spike := loss > factor * median(ring)
    spike_min_history: int = 5    # detector disarmed below this many entries
    spike_floor: float = 1e-3     # median floor (a fully-converged run must
                                  # not flag ordinary noise as a spike)
    # escalation ladder
    bisect: bool = True           # per-scene bisection of a bad batch
    rollback_after: int = 3       # consecutive nothing-committed steps
                                  # before rolling back to last_good
    max_rollbacks: int = 2        # then TrainAbortError
    # checkpoint cadence (needs a manager on the trainer)
    ckpt_every: int = 0           # save every N committed steps (0 = off)
    last_good_after: int = 2      # healthy steps after a save before the
                                  # last_good tag advances to it


class LossSpikeDetector:
    """Median-of-ring-buffer spike detector over *committed* losses.

    ``is_spike(loss)`` is True when the history is armed
    (``>= min_history`` entries) and ``loss > factor * max(median,
    floor)``. Only committed losses enter the ring, so a run of poisoned
    batches cannot drag the baseline up to meet itself."""

    def __init__(self, window: int = 16, factor: float = 10.0,
                 min_history: int = 5, floor: float = 1e-3):
        self.window = window
        self.factor = factor
        self.min_history = min_history
        self.floor = floor
        self.ring: List[float] = []

    def is_spike(self, loss: float) -> bool:
        if len(self.ring) < self.min_history:
            return False
        med = float(np.median(self.ring))
        return loss > self.factor * max(med, self.floor)

    def record(self, loss: float) -> None:
        self.ring.append(float(loss))
        if len(self.ring) > self.window:
            self.ring.pop(0)

    def reset(self) -> None:
        """Forget the baseline (after a rollback the params changed)."""
        self.ring.clear()


@dataclasses.dataclass
class TrainHealthReport:
    """Per-:meth:`~GuardedPointCloudTrainer.step` degradation accounting.

    ``committed`` lists one entry per optimizer update actually applied
    this call, in commit order: ``None`` means the full batch as given;
    a list of scene indices means a bisection sub-batch. Replaying exactly
    these groups through a plain trainer reproduces the guarded run's
    params bitwise."""

    step: int                     # optimizer step count at entry
    action: str = "ok"            # "ok" | "skipped" | "bisected" |
                                  # "rolled_back"
    loss: float = float("nan")    # full-batch loss as computed
    grad_norm: float = float("nan")
    nonfinite: bool = False       # the all-finite flag tripped
    spike: bool = False           # the spike detector tripped
    committed: List[Optional[List[int]]] = dataclasses.field(
        default_factory=list)
    quarantined: List[int] = dataclasses.field(default_factory=list)
    rollback_to: Optional[int] = None   # checkpoint step restored, if any

    @property
    def ok(self) -> bool:
        """The batch trained exactly as submitted (no degradation)."""
        return self.action == "ok"

    def summary(self) -> str:
        parts = [f"step={self.step} action={self.action} "
                 f"loss={self.loss:.4g}"]
        if self.nonfinite:
            parts.append("nonfinite")
        if self.spike:
            parts.append("spike")
        if self.committed:
            groups = ["all" if g is None else str(g) for g in self.committed]
            parts.append(f"committed={','.join(groups)}")
        if self.quarantined:
            parts.append(f"quarantined={self.quarantined}")
        if self.rollback_to is not None:
            parts.append(f"rollback_to={self.rollback_to}")
        return " ".join(parts)


# ---------------------------------------------------------------------------
# the guarded update + step
# ---------------------------------------------------------------------------

def guarded_apply_updates(params, grads, opt_state: OptState,
                          cfg: AdamWConfig, *, loss=None):
    """The AdamW update, staged, with one all-finite flag.

    ``ok = isfinite(global_norm(grads))`` — a single NaN/Inf anywhere makes
    the norm non-finite — ``& isfinite(loss)`` when a loss is given.
    Returns ``(staged, metrics)``: ``staged`` is an
    ``optimizer.StagedUpdate`` (nothing written yet; ``staged.commit()``
    writes it and returns the new state, bitwise the plain
    ``apply_updates``), ``metrics["step_ok"]`` the 0-d bool flag. The
    flag stays on the device: whoever reads it decides whether to commit
    (module doc). No host sync."""
    staged, metrics = stage_updates(params, grads, opt_state, cfg)
    ok = torch.isfinite(metrics["grad_norm"])
    if loss is not None:
        ok = ok & torch.isfinite(loss)
    metrics["step_ok"] = ok
    return staged, metrics


def make_guarded_train_step(
    net: PointCloudNet,
    layout: BitLayout,
    tcfg: PointCloudTrainConfig,
    *,
    engine: str = "zdelta_cuda",
    downsample_method: str = "auto",
    segment: Optional[SegmentSpec] = None,
) -> Callable:
    """``make_pointcloud_train_step`` with the update staged through
    :func:`guarded_apply_updates` (the span ``optimizer``): ``step(params,
    opt_state, packed, feats, labels) -> (staged, metrics)``, one extra
    metric (``step_ok``)."""
    grad_fn = make_grad_fn(net, layout, engine=engine,
                           downsample_method=downsample_method,
                           segment=segment)

    def step(params, opt_state: OptState, packed, feats, labels):
        named, grads, loss, acc = grad_fn(params, packed, feats, labels)
        with span("optimizer"):
            staged, metrics = guarded_apply_updates(named, grads, opt_state,
                                                    tcfg.opt, loss=loss)
        metrics.update(loss=loss, accuracy=acc)
        return staged, metrics

    return step


# ---------------------------------------------------------------------------
# the guarded trainer (host layers of the ladder)
# ---------------------------------------------------------------------------

class GuardedPointCloudTrainer(PointCloudTrainer):
    """A :class:`~repro_torch.train.PointCloudTrainer` wrapped in the
    degraded-mode contract (module doc) — built by
    ``session.compile_train(guard=...)``.

    Same :meth:`step` surface as the plain trainer (metrics dict, with
    ``step_ok``); every call also leaves a :class:`TrainHealthReport` on
    :attr:`last_report` and updates :attr:`counters`. ``ckpt`` (a
    ``CheckpointManager`` or a directory) enables auto-checkpointing, the
    ``last_good`` rollback anchor and :meth:`resume`."""

    # plain-int views over the session's registry counters (obs), zeroed
    # in __init__
    steps_total = CounterView("train_steps_total")
    steps_ok = CounterView("train_steps_ok")
    steps_skipped = CounterView("train_steps_skipped")
    nonfinite_steps = CounterView("train_nonfinite_steps")
    spikes = CounterView("train_spikes")
    bisections = CounterView("train_bisections")
    sub_steps_committed = CounterView("train_sub_steps_committed")
    scenes_quarantined = CounterView("train_scenes_quarantined")
    rollbacks = CounterView("train_rollbacks")
    checkpoint_saves = CounterView("train_checkpoint_saves")

    def __init__(self, session, tcfg: Optional[PointCloudTrainConfig] = None,
                 *, guard: Optional[GuardConfig] = None,
                 ckpt=None, opt_state=None, resume: bool = False):
        super().__init__(session, tcfg, opt_state=opt_state)
        self.guard = guard if guard is not None else GuardConfig()
        self._step = make_guarded_train_step(
            session.net, session.layout, self.tcfg, engine=session.engine,
            downsample_method=session.downsample_method,
            segment=session.segment)
        self.ckpt: Optional[CheckpointManager] = (
            CheckpointManager(ckpt, metrics=self.metrics)
            if isinstance(ckpt, str) else ckpt)
        self._spikes = LossSpikeDetector(
            window=self.guard.spike_window, factor=self.guard.spike_factor,
            min_history=self.guard.spike_min_history,
            floor=self.guard.spike_floor)
        self.last_report: Optional[TrainHealthReport] = None
        self._consec_bad = 0          # steps in a row with nothing committed
        self._healthy_streak = 0      # consecutive steps without any fault
        # saves awaiting blessing: (step, healthy_streak at save time) —
        # blessed when the streak reaches that value + last_good_after;
        # any bad step cancels the whole list (module doc)
        self._pending: List[Tuple[int, int]] = []
        self._last_saved = 0
        self.steps_total = 0
        self.steps_ok = 0
        self.steps_skipped = 0
        self.nonfinite_steps = 0
        self.spikes = 0
        self.bisections = 0
        self.sub_steps_committed = 0
        self.scenes_quarantined = 0
        self.rollbacks = 0
        self.checkpoint_saves = 0
        if resume:
            self.resume()

    @property
    def counters(self) -> dict:
        """The degraded-mode counters as one dict, plus the checkpoint
        manager's verification failures and the current ``last_good``
        anchor (-1 when absent)."""
        out = {k: getattr(self, k) for k in (
            "steps_total", "steps_ok", "steps_skipped", "nonfinite_steps",
            "spikes", "bisections", "sub_steps_committed",
            "scenes_quarantined", "rollbacks", "checkpoint_saves")}
        out["checksum_failures"] = (self.ckpt.verify_failures
                                    if self.ckpt is not None else 0)
        lg = (self.ckpt.last_good_step() if self.ckpt is not None else None)
        out["last_good_step"] = -1 if lg is None else lg
        return out

    # -- ladder rungs 1+2: guarded attempt (finite flag + spike) ----------

    def _attempt(self, st: SparseTensor, labels) -> Tuple[dict, str]:
        """One guarded update attempt. Commits (params, opt state, spike
        ring) only when healthy; returns (metrics, status) with status in
        {"ok", "nonfinite", "spike"}."""
        with span("train/pack", self.metrics):
            stp, labp = self._prepare(st, labels)
        self._buckets.add(stp.capacity)
        # the span ends after the metrics' read, which waits for the device
        with span("train/step", self.metrics):
            staged, metrics = self._step(
                self.session.params, self.opt_state, stp.packed, stp.features,
                labp)
            m = read_metrics(metrics)
        if m["step_ok"] < 0.5:
            return m, "nonfinite"
        if self._spikes.is_spike(m["loss"]):
            return m, "spike"
        self.opt_state = staged.commit()
        self._spikes.record(m["loss"])
        return m, "ok"

    # -- ladder rung 3: per-scene bisection -------------------------------

    def _scene_clouds(self, st: SparseTensor, labels) -> List[tuple]:
        """Split a labeled batch into per-scene ``(scene_index, coords,
        feats, labels)`` on its scene segments (host-side; empty scene
        slots dropped). The rows are batch-major sorted, so labels slice
        on the same segments as the tensor."""
        starts, _ = st.scene_segments()
        lab = torch.as_tensor(labels).cpu().numpy()
        out = []
        for i, scene in enumerate(st.unbatch()):
            n = int(scene.count)
            if n == 0:
                continue
            coords, _ = scene.coords()
            out.append((i, coords, scene.features[:n].cpu().numpy(),
                        lab[starts[i]: starts[i] + n]))
        return out

    def _bisect(self, scenes: List[tuple], report: TrainHealthReport) -> int:
        """Bisection quarantine over scenes: a refused sub-batch splits in
        halves until the poison stands alone (quarantined); every healthy
        sub-batch commits one update. The whole list was just refused
        from this same state, so the search starts at its halves (the
        reference attempts the whole list once more, which can only be
        refused again). Re-packing uses ``validate="none"``: the rows
        passed the ingest boundary once, and the faults this rung exists
        for are the ones validation cannot see."""
        committed = 0

        def split(sub: List[tuple]) -> None:
            if len(sub) == 1:
                report.quarantined.append(sub[0][0])
                self.scenes_quarantined += 1
                return
            mid = len(sub) // 2
            serve(sub[:mid])
            serve(sub[mid:])

        def serve(sub: List[tuple]) -> None:
            nonlocal committed
            sst, slab = labeled_tensor(
                [(c, f, l) for _, c, f, l in sub], self.session.layout,
                ignore_label=self.tcfg.ignore_label, validate="none",
                device=self.session.device)
            _, status = self._attempt(sst, slab)
            if status == "ok":
                committed += 1
                self.sub_steps_committed += 1
                report.committed.append([i for i, _, _, _ in sub])
                return
            split(sub)

        split(scenes)
        return committed

    # -- ladder rungs 4+5: rollback / abort --------------------------------

    def _escalate(self, report: TrainHealthReport) -> None:
        """``rollback_after`` consecutive dead steps: restore the newest
        verifying checkpoint at or before the ``last_good`` tag; abort
        (typed) when that is impossible or exhausted."""
        if self.ckpt is None:
            raise TrainAbortError(
                f"{self._consec_bad} consecutive unusable batches and no "
                "checkpoint manager to roll back to — attach one via "
                "session.compile_train(guard=..., ckpt=dir)",
                report=report, counters=self.counters)
        if self.rollbacks >= self.guard.max_rollbacks:
            raise TrainAbortError(
                f"still failing after {self.rollbacks} rollbacks "
                f"(max_rollbacks={self.guard.max_rollbacks}) — the fault is "
                "not in the optimizer state; inspect the data pipeline",
                report=report, counters=self.counters)
        try:
            s = self._restore(self.ckpt.last_good_step())
        except CheckpointError as e:
            raise TrainAbortError(
                f"rollback failed: {e}", report=report,
                counters=self.counters) from e
        self.rollbacks += 1
        self._consec_bad = 0
        self._last_saved = s       # the cadence restarts from the anchor
        self._spikes.reset()       # the baseline belongs to the old params
        report.action = "rolled_back"
        report.rollback_to = s

    # -- checkpoint cadence + the last_good tag ----------------------------

    def _after_healthy(self) -> None:
        """Auto-checkpoint cadence and last_good advancement (module doc):
        bump the healthy streak, bless the newest pending save followed by
        ``last_good_after`` healthy steps, then save on the cadence."""
        if self.ckpt is None:
            return
        self._healthy_streak += 1
        ripe = [(s, at) for s, at in self._pending
                if self._healthy_streak >= at + self.guard.last_good_after]
        if ripe:
            newest = max(s for s, _ in ripe)
            self.ckpt.mark_last_good(newest)
            self._pending = [(s, at) for s, at in self._pending
                             if s > newest]
        step = self.opt_state.step
        if (self.guard.ckpt_every
                and step - self._last_saved >= self.guard.ckpt_every):
            self.ckpt.save(step, *checkpoint_trees(self.session.params,
                                                   self.opt_state))
            self.checkpoint_saves += 1
            self._last_saved = step
            self._pending.append((step, self._healthy_streak))

    def _after_faulty(self) -> None:
        """Any detected fault: reset the healthy streak and cancel pending
        blessings — a checkpoint taken just before trouble is never blessed
        as the rollback anchor."""
        self._healthy_streak = 0
        self._pending.clear()

    def save(self, *, mark_good: bool = False) -> int:
        """Checkpoint now (outside the cadence). ``mark_good=True`` also
        advances the ``last_good`` tag at once — for a caller with
        independent evidence that the state is healthy (an eval pass)."""
        if self.ckpt is None:
            raise ValueError("no CheckpointManager attached — "
                             "compile_train(guard=..., ckpt=dir)")
        step = self.opt_state.step
        self.ckpt.save(step, *checkpoint_trees(self.session.params,
                                               self.opt_state))
        self.checkpoint_saves += 1
        self._last_saved = step
        if mark_good:
            self.ckpt.mark_last_good(step)
            self._pending = [(s, at) for s, at in self._pending if s > step]
        else:
            self._pending.append((step, self._healthy_streak))
        return step

    def resume(self) -> Optional[int]:
        """Crash-safe resume: restore the newest checkpoint that verifies
        (corrupt or torn checkpoints are walked past and counted in
        ``counters["checksum_failures"]``). Returns the restored step, or
        None when the directory is empty."""
        if self.ckpt is None or not self.ckpt.steps():
            return None
        s = self._restore(None)
        self._last_saved = s
        return s

    def _restore(self, step: Optional[int]) -> int:
        """Restore the newest checkpoint that verifies, at or before
        ``step``, into the session's parameters and the AdamW state in
        place; returns the checkpoint's step."""
        _, opt, s = self.ckpt.restore(
            step, *checkpoint_trees(self.session.params, self.opt_state),
            fallback=True)
        self.opt_state = self.opt_state._replace(step=int(opt[".step"]))
        return s

    # -- the guarded step ---------------------------------------------------

    def step(self, st: SparseTensor, labels) -> dict:
        """One guarded optimization step (module doc). Returns the plain
        trainer's metrics dict plus ``step_ok``; the defensive story of the
        call lands on :attr:`last_report`."""
        self.steps_total += 1
        report = TrainHealthReport(step=self.opt_state.step)
        m, status = self._attempt(st, labels)
        report.loss = m["loss"]
        report.grad_norm = m["grad_norm"]
        if status == "ok":
            self.steps_ok += 1
            report.committed.append(None)      # the full batch, as given
            self._consec_bad = 0
            self._after_healthy()
            self.last_report = report
            return m
        # full batch refused: nothing was committed
        self.steps_skipped += 1
        report.nonfinite = status == "nonfinite"
        report.spike = status == "spike"
        if report.nonfinite:
            self.nonfinite_steps += 1
        else:
            self.spikes += 1
        report.action = "skipped"
        committed = 0
        scenes = (self._scene_clouds(st, labels)
                  if self.guard.bisect else [])
        if len(scenes) > 1:
            self.bisections += 1
            report.action = "bisected"
            with span("train/bisect", self.metrics):
                committed = self._bisect(scenes, report)
        elif len(scenes) == 1:
            # single-scene batch: nothing to bisect — the scene IS the fault
            report.quarantined.append(scenes[0][0])
            self.scenes_quarantined += 1
        self._after_faulty()    # never bless a save followed by a fault
        if committed:
            self._consec_bad = 0
        else:
            self._consec_bad += 1
            if self._consec_bad >= self.guard.rollback_after:
                self._escalate(report)
        self.last_report = report
        return m

    def __repr__(self):
        return (f"GuardedPointCloudTrainer({self.session.net.name}, "
                f"step={self.opt_state.step}, "
                f"ok={self.steps_ok}/{self.steps_total}, "
                f"quarantined={self.scenes_quarantined}, "
                f"rollbacks={self.rollbacks})")
