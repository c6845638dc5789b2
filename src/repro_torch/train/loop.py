"""LM training step and loop (torch port of ``repro.train.loop``): remat,
gradient accumulation, compression, fault-tolerance hooks.

``make_train_step`` builds the step (loss → grad → optional compression →
clip → AdamW); ``train`` drives it with checkpointing, a preemption handler
(SIGTERM forces a final checkpoint) and a per-step watchdog that records
straggling steps.

The parameter tree stays in the reference's layout, every per-layer leaf
stacked on a leading layer axis under ``"sb<i>"`` (checkpoints and
``convert`` read it so). The step does not differentiate through views of
the stacks: autograd's backward of ``stack[r]`` allocates a zero tensor of
the whole stack for every layer. Its leaves are per-layer tensors that
share the stacks' storage (``stack.unbind(0)``, each detached and requiring
grad), handed to the model as tuples in place of the stacks
(``transformer`` reads ``t[r]`` of either), so the gradients come out one
per layer. The AdamW update runs per layer slice as well
(``optimizer.apply_updates_parts``), so no fp32 temporary is larger than
one layer's leaf. The update is elementwise, so it computes what the
reference's does; only the gradient norm's sum runs in another order
(each stacked leaf's layers in turn, not the whole leaf at once).

Under a mesh the step runs on DTensor parameters and moments
(``dist.distribute_params``) inside ``dist.sharding_ctx``: the batch is
placed on ``("pod", "data")`` (``dist.sharding.shard_batch``), each
gradient is brought to its parameter's placement (a partial sum over the
data axis becomes its shard: a reduce-scatter) before the update, and the
gradient norm sums each rank's partial sums and all-reduces them (another
add order across ranks; at world size 1 the same). The loss and the norm
come back as plain tensors.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..dist.sharding import is_dtensor, shard_batch, whole
from ..models import transformer as tf
from ..models.common import ModelConfig
from . import compression
from .optimizer import AdamWConfig, OptState, apply_updates_parts, \
    init_opt_state


@dataclasses.dataclass
class TrainConfig:
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    remat: bool = True
    grad_accum: int = 1
    compress_grads: bool = False
    log_every: int = 10
    ckpt_every: int = 100
    watchdog_factor: float = 3.0   # step > factor × median ⇒ straggler log


def _paths(tree: dict, prefix: tuple = ()) -> Iterator[Tuple[tuple, object]]:
    """(key path, leaf) in sorted-key order: the reference's
    ``jax.tree.leaves`` order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _stacked(path: tuple) -> bool:
    return path[0].startswith("sb")


def step_leaves(params: dict) -> Tuple[dict, List[tuple]]:
    """The step's differentiable leaves (module doc): ``(tree, entries)``,
    the tree in ``params``' nesting with each stacked leaf a tuple of
    per-layer tensors sharing its storage and every leaf detached and
    requiring grad; ``entries`` the ``(path, leaf or tuple)`` pairs in the
    reference's leaf order."""
    tree: dict = {}
    entries = []
    for path, t in _paths(params):
        if _stacked(path):
            leaf = tuple(x.detach().requires_grad_() for x in t.unbind(0))
        else:
            leaf = t.detach().requires_grad_()
        _put(tree, path, leaf)
        entries.append((path, leaf))
    return tree, entries


def _micro(x, n: int, i: int):
    """Micro-batch ``i`` of ``n`` along the batch axis: the reference's
    ``x.reshape(n, -1, ...)[i]``."""
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} does not split into "
                         f"{n} micro-batches")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def _placed(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placement; else ``g``."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """Returns ``step(params, opt_state, batch[, residual]) → (params,
    opt_state, metrics[, residual])``, updating ``params`` and the moments
    in place on their device. ``batch``: ``tokens`` / ``embeds`` and
    ``labels`` (numpy arrays or tensors). With ``grad_accum > 1`` the batch
    splits into that many micro-batches whose gradients sum in fp32 in
    order before the division (``metrics["loss"]`` is the last
    micro-batch's, as the reference's scan carries it). With
    ``compress_grads`` the step also takes and returns the fp32 residual
    tree, in the parameters' stacked shapes."""

    def value_and_grad(tree, flat, batch):
        loss = tf.loss_fn(tree, cfg, batch, remat=tcfg.remat)
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    def step(params, opt_state: OptState, batch, residual=None):
        ref = params["final_norm"]
        if is_dtensor(ref):
            batch = shard_batch(batch, ref.device_mesh, ref.to_local().device)
        tree, entries = step_leaves(params)
        flat = [x for _, leaf in entries
                for x in (leaf if isinstance(leaf, tuple) else (leaf,))]
        with torch.enable_grad():
            if tcfg.grad_accum == 1:
                loss, grads = value_and_grad(tree, flat, batch)
            else:
                n = tcfg.grad_accum
                gsum = None
                for i in range(n):
                    mb = {k: _micro(v, n, i) for k, v in batch.items()
                          if v is not None}
                    loss, g = value_and_grad(tree, flat, mb)
                    g = [x.float() for x in g]
                    gsum = g if gsum is None else [
                        a + b for a, b in zip(gsum, g)]
                grads = [g / n for g in gsum]
        del tree, flat
        # regroup: one gradient per leaf, or per layer of a stacked leaf
        per_leaf, at = [], 0
        for _, leaf in entries:
            n_parts = len(leaf) if isinstance(leaf, tuple) else 1
            per_leaf.append(grads[at:at + n_parts])
            at += n_parts
        del grads
        if tcfg.compress_grads:
            stacked: dict = {}
            for (path, leaf), gs in zip(entries, per_leaf):
                _put(stacked, path, torch.stack(gs) if isinstance(leaf, tuple)
                     else gs[0])
            stacked, residual = compression.compress_tree(stacked, residual)
            per_leaf = [list(_get(stacked, path)) if isinstance(leaf, tuple)
                        else [_get(stacked, path)]
                        for path, leaf in entries]
        parts = []
        for (path, leaf), gs in zip(entries, per_leaf):
            p = _get(params, path)
            m, v = _get(opt_state.mu, path), _get(opt_state.nu, path)
            if isinstance(leaf, tuple):
                parts += [(p[r], _placed(g, p[r]), m[r], v[r])
                          for r, g in enumerate(gs)]
            else:
                parts.append((p, _placed(gs[0], p), m, v))
        del entries
        opt_state, metrics = apply_updates_parts(parts, opt_state, tcfg.opt)
        metrics["loss"] = whole(loss)
        metrics["grad_norm"] = whole(metrics["grad_norm"])
        if tcfg.compress_grads:
            return params, opt_state, metrics, residual
        return params, opt_state, metrics

    return step


def checkpoint_trees(params: dict, opt_state: OptState) -> Tuple[dict, dict]:
    """The LM training state as the reference's checkpoint manager
    flattens it, the live tensors as leaves: the parameter tree, and the
    AdamW state under the ``OptState`` fields ``.mu``, ``.nu``
    (parameter-shaped trees) and ``.step`` (a 0-d int32). A
    ``ckpt.CheckpointManager`` saves these under the reference's keys and
    restores into them in place."""
    return params, {".mu": opt_state.mu, ".nu": opt_state.nu,
                    ".step": np.asarray(opt_state.step, np.int32)}


def restore(manager, params: dict, opt_state: OptState,
            step: Optional[int] = None, **kw) -> Tuple[dict, OptState, int]:
    """Restore a checkpoint (the newest with ``step=None``) into ``params``
    and ``opt_state``'s tensors in place: ``(params, opt_state, step)``.
    ``kw`` goes to ``manager.restore`` (``verify``, ``fallback``)."""
    p, o, at = manager.restore(step, *checkpoint_trees(params, opt_state),
                               **kw)
    return p, OptState(o[".mu"], o[".nu"], int(np.asarray(o[".step"]))), at


class PreemptionGuard:
    """SIGTERM → request a final checkpoint and clean exit."""

    def __init__(self):
        self.requested = False
        for sig in (signal.SIGTERM,):
            try:
                signal.signal(sig, self._handler)
            except ValueError:
                pass  # non-main thread (tests)

    def _handler(self, *_):
        self.requested = True


def train(cfg: ModelConfig, tcfg: TrainConfig, data: Iterator,
          n_steps: int, params=None, opt_state=None, start_step: int = 0,
          ckpt_manager=None, log: Optional[Callable] = print, *,
          device="cuda"):
    """Single-card driver: steps ``start_step .. n_steps - 1`` on batches
    from ``data``; parameters from seed 0 on ``device`` when not given.
    Checkpoints every ``ckpt_every`` steps, at the last step and on
    SIGTERM (then stops); logs a step that takes ``watchdog_factor`` times
    the median (after 5 steps). Returns ``(params, opt_state, metrics)``."""
    if params is None:
        params = tf.init_params(cfg, 0, device=device)[0]
    if opt_state is None:
        opt_state = init_opt_state(params, tcfg.opt)
    step_fn = make_train_step(cfg, tcfg)
    guard = PreemptionGuard()
    residual = None
    durations = []
    metrics = {}
    for step in range(start_step, n_steps):
        batch = next(data)
        t0 = time.perf_counter()
        if tcfg.compress_grads:
            params, opt_state, metrics, residual = step_fn(
                params, opt_state, batch, residual)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])           # waits for the step
        dt = time.perf_counter() - t0
        durations.append(dt)
        med = sorted(durations)[len(durations) // 2]
        if dt > tcfg.watchdog_factor * med and len(durations) > 5 and log:
            log(f"[watchdog] step {step} took {dt:.2f}s (median {med:.2f}s) — "
                "straggling host or input stall")
        if log and step % tcfg.log_every == 0:
            log(f"step {step} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        if ckpt_manager is not None and (
                step % tcfg.ckpt_every == 0 or guard.requested
                or step == n_steps - 1):
            ckpt_manager.save(step, *checkpoint_trees(params, opt_state))
        if guard.requested:
            if log:
                log(f"[preempt] checkpointed at step {step}, exiting")
            break
    return params, opt_state, metrics
