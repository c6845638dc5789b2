"""Load the JAX package's parameters and optimizer state into the port's.

The JAX parameter tree of a point-cloud net is ``{layer: {"w", "b"},
"head"}``; taken to numpy with ``jax.tree.map(np.asarray, params)`` it is
plain arrays, which is all this module reads (it imports no JAX). With the
same weights in both packages, their outputs can be held against each
other; with the same AdamW state, one update step can.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .core.spconv import SpConv
from .models.pointcloud import PointCloudModel, PointCloudNet
from .train.optimizer import OptState


def _tensor(a, shape, what: str, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {a.shape}, expected {shape}")
    return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                        dtype=dtype)


def _named_from_jax(tree: Mapping, net: PointCloudNet, device,
                    dtype) -> Dict[str, torch.Tensor]:
    """A JAX parameter-shaped tree → tensors under the port's parameter
    names (``PointCloudModel.named_parameters()``), shapes checked."""
    out = {}
    for s in net.specs:
        p = tree[s.name]
        out[f"layers.{s.name}.weight"] = _tensor(
            p["w"], (s.K ** 3, s.cin, s.cout), f"{s.name}.w", device, dtype)
        if s.bias:
            out[f"layers.{s.name}.bias"] = _tensor(
                p["b"], (s.cout,), f"{s.name}.b", device, dtype)
    out["head"] = _tensor(tree["head"], (net.specs[-1].cout, net.n_classes),
                          "head", device, dtype)
    return out


def params_from_jax(tree: Mapping, net: PointCloudNet, *, device="cuda",
                    dtype=torch.float32) -> PointCloudModel:
    """The numpy form of a JAX parameter tree → a :class:`PointCloudModel`
    for ``net`` on ``device``. Shapes are checked against the specs."""
    t = _named_from_jax(tree, net, device, dtype)
    layers = {s.name: SpConv(s, t[f"layers.{s.name}.weight"],
                             t.get(f"layers.{s.name}.bias"))
              for s in net.specs}
    return PointCloudModel(net, layers, t["head"])


def opt_state_from_jax(state, net: PointCloudNet, *, device="cuda",
                       dtype=torch.float32) -> OptState:
    """The numpy form of a JAX ``OptState`` (``mu``, ``nu`` parameter-shaped
    trees, ``step``) → the port's :class:`~repro_torch.train.OptState`,
    keyed by the port's parameter names."""
    return OptState(mu=_named_from_jax(state.mu, net, device, dtype),
                    nu=_named_from_jax(state.nu, net, device, dtype),
                    step=int(np.asarray(state.step)))
