"""AdamW with fp32 moments (torch port of ``repro.train.optimizer``).

Parameters, gradients and moments are dictionaries of tensors keyed by
parameter name (``dict(model.named_parameters())``), or nested dicts (an
LM's parameter tree; :func:`init_opt_state` keeps the nesting). An LM step
updates through :func:`apply_updates_parts`: the same AdamW over
(parameter, gradient, moment, moment) parts that may be slices of a
stacked leaf, so no temporary is larger than one layer. The update runs in
fp32 and is applied **in place**: the parameter tensors and the moment
tensors are overwritten (the reference returns new arrays; updating in
place keeps one copy of each on the card, and a session's modules serve
the new weights without a hand-off). ``step`` is a host integer, so the
learning-rate schedule needs no device sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, NamedTuple, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    state_dtype: str = "float32"


class OptState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    step: int


def init_opt_state(params: dict, cfg: AdamWConfig) -> OptState:
    """Zero moments in ``cfg.state_dtype`` shaped (and, for DTensor
    parameters, placed) as ``params`` (a dict of tensors, possibly nested),
    step 0."""
    dt = getattr(torch, cfg.state_dtype)

    def zeros(tree):
        return {k: zeros(p) if isinstance(p, dict)
                else torch.zeros_like(p, dtype=dt,
                                      memory_format=torch.contiguous_format)
                for k, p in tree.items()}
    return OptState(mu=zeros(params), nu=zeros(params), step=0)


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup over ``warmup_steps``, then a cosine decay to 10% of
    ``lr`` at ``total_steps``."""
    warm = min(1.0, (step + 1) / max(cfg.warmup_steps, 1))
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """√(Σ over the tensors, in order, of Σ x²) in fp32, as a 0-d tensor."""
    total = None
    for x in tensors:
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """√(Σ over the tensors of Σ x²) in fp32, as a 0-d tensor."""
    return _norm(tree.values())


def _step_scalars(gnorm: torch.Tensor, state: OptState, cfg: AdamWConfig):
    """The step's shared factors from the gradient norm (0-d): the norm,
    its clip scale (0-d), the learning rate and the two bias corrections
    (host floats)."""
    step = state.step + 1
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    return gnorm, scale, lr_at(cfg, state.step), 1 - cfg.b1 ** step, \
        1 - cfg.b2 ** step


def _leaf_update(p, g, m, v, scale, lr: float, bc1: float, bc2: float,
                 cfg: AdamWConfig):
    """One tensor's new (param, first moment, second moment), out of place.
    The plain and the guarded update both go through here, so a committed
    guarded step is bitwise the plain one."""
    b1, b2 = cfg.b1, cfg.b2
    g32 = g.float() * scale
    m32 = b1 * m.float() + (1 - b1) * g32
    v32 = b2 * v.float() + (1 - b2) * g32 * g32
    delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) \
        + cfg.weight_decay * p.float()
    return p.float() - lr * delta, m32, v32


@torch.no_grad()
def _commit(p, m, v, new) -> None:
    p.copy_(new[0])
    m.copy_(new[1])
    v.copy_(new[2])


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state: OptState,
                  cfg: AdamWConfig):
    """One AdamW step with global-norm clipping, in place on ``params`` and
    on the state's moments. Returns ``(params, new_state, metrics)`` with
    ``metrics = {"grad_norm": 0-d tensor, "lr": float}``, as the
    reference's ``(new_params, new_state, metrics)``."""
    gnorm, scale, lr, bc1, bc2 = _step_scalars(global_norm(grads), state,
                                               cfg)
    for k, p in params.items():
        _commit(p, state.mu[k], state.nu[k], _leaf_update(
            p, grads[k], state.mu[k], state.nu[k], scale, lr, bc1, bc2, cfg))
    return params, OptState(state.mu, state.nu, state.step + 1), {
        "grad_norm": gnorm, "lr": lr}


class StagedUpdate:
    """An AdamW step computed out of place and not yet written: the
    guarded trainer's update (``train.guard``). :meth:`commit` copies the
    new values into the parameter and moment tensors and returns the new
    state; dropping the object leaves them bitwise as they were."""

    def __init__(self, params, state: OptState, new: dict):
        self.params = params
        self.state = state
        self.new = new

    def commit(self) -> OptState:
        for k, p in self.params.items():
            _commit(p, self.state.mu[k], self.state.nu[k], self.new[k])
        return OptState(self.state.mu, self.state.nu, self.state.step + 1)


@torch.no_grad()
def stage_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state: OptState,
                  cfg: AdamWConfig):
    """The AdamW step of :func:`apply_updates`, same ops in the same order,
    with nothing written: returns ``(StagedUpdate, metrics)``. Holds one
    extra copy of the parameters and of both moments until committed or
    dropped."""
    gnorm, scale, lr, bc1, bc2 = _step_scalars(global_norm(grads), state,
                                               cfg)
    new = {k: _leaf_update(p, grads[k], state.mu[k], state.nu[k], scale, lr,
                           bc1, bc2, cfg) for k, p in params.items()}
    return StagedUpdate(params, state, new), {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def apply_updates_parts(parts: Sequence[Tuple[torch.Tensor, ...]],
                        state: OptState, cfg: AdamWConfig):
    """The AdamW step of :func:`apply_updates` over ``parts``, each
    ``(param, grad, mu, nu)`` — whole leaves or slices of stacked ones
    (views, written in place) — with the gradient norm summed over the
    parts in their order. Returns ``(new_state, metrics)``; the moments in
    ``state`` are the parts' bases, already updated."""
    gnorm, scale, lr, bc1, bc2 = _step_scalars(
        _norm(g for _, g, _, _ in parts), state, cfg)
    for p, g, m, v in parts:
        _commit(p, m, v, _leaf_update(p, g, m, v, scale, lr, bc1, bc2, cfg))
    return OptState(state.mu, state.nu, state.step + 1), {
        "grad_norm": gnorm, "lr": lr}
