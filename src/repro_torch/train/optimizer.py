"""AdamW with fp32 moments (torch port of ``repro.train.optimizer``).

Parameters, gradients and moments are dictionaries of tensors keyed by
parameter name (``dict(model.named_parameters())``). The update runs in
fp32 and is applied **in place**: the parameter tensors and the moment
tensors are overwritten (the reference returns new arrays; updating in
place keeps one copy of each on the card, and a session's modules serve
the new weights without a hand-off). ``step`` is a host integer, so the
learning-rate schedule needs no device sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple

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


def init_opt_state(params: Dict[str, torch.Tensor],
                   cfg: AdamWConfig) -> OptState:
    dt = getattr(torch, cfg.state_dtype)
    return OptState(
        mu={k: torch.zeros(p.shape, dtype=dt, device=p.device)
            for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=dt, device=p.device)
            for k, p in params.items()},
        step=0)


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup over ``warmup_steps``, then a cosine decay to 10% of
    ``lr`` at ``total_steps``."""
    warm = min(1.0, (step + 1) / max(cfg.warmup_steps, 1))
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """√(Σ over the tensors of Σ x²) in fp32, as a 0-d tensor."""
    total = None
    for x in tree.values():
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state: OptState,
                  cfg: AdamWConfig):
    """One AdamW step with global-norm clipping, in place on ``params`` and
    on the state's moments. Returns ``(params, new_state, metrics)`` with
    ``metrics = {"grad_norm": 0-d tensor, "lr": float}``, as the
    reference's ``(new_params, new_state, metrics)``."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, state.step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    for k, p in params.items():
        g32 = grads[k].float() * scale
        m32 = b1 * state.mu[k].float() + (1 - b1) * g32
        v32 = b2 * state.nu[k].float() + (1 - b2) * g32 * g32
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        state.mu[k].copy_(m32)
        state.nu[k].copy_(v32)
    return params, OptState(state.mu, state.nu, step), {"grad_norm": gnorm,
                                                        "lr": lr}
