"""Carry parameters and optimizer state between the JAX package and the
port, both ways.

The JAX parameter tree of a point-cloud net is ``{layer: {"w", "b"},
"head"}``, and that of an LM ``{"embed", "final_norm", "lm_head"?,
"sb<i>": {"b<j>": {...}, "f<j>": {...}}}`` with per-layer leaves stacked
on axis 0 (the port's LM tree is the same nesting); taken to numpy with
``jax.tree.map(np.asarray, params)`` they are plain arrays, which is all
this module reads (it imports no JAX). An LM's AdamW state converts as
the reference's ``OptState`` (``lm_opt_state_from_jax`` /
``lm_opt_state_to_jax``): moments in the parameters' nesting, fp32. With
the same weights in both packages, their outputs can be held against each
other; with the same AdamW state, one update step can. The reverse direction
(:func:`params_to_jax`, :func:`opt_state_to_jax`) gives the numpy form of
the JAX trees. Both nest the port's tensors as the JAX trees through
``models.pointcloud.jax_tree``, as the guarded trainer does when it hands
its state to the checkpoint manager (``train.guard.checkpoint_trees``), so
either package restores the other's checkpoints.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .core.spconv import SpConv
from .models.common import ModelConfig
from .models.transformer import param_shapes
from .models.pointcloud import PointCloudModel, PointCloudNet, jax_tree
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


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that no later in-place update can reach (on
    the CPU ``.cpu()`` would return the same storage)."""
    return t.detach().to("cpu", copy=True).numpy()


def _host_tree(named: Mapping[str, torch.Tensor],
               net: PointCloudNet) -> dict:
    return jax_tree({k: _host(t) for k, t in named.items()}, net)


def params_to_jax(model: PointCloudModel, net: PointCloudNet) -> dict:
    """A :class:`PointCloudModel` → the numpy form of the JAX parameter
    tree ``{layer: {"w", "b"?}, "head"}`` (host copies; the inverse of
    :func:`params_from_jax`)."""
    return _host_tree(dict(model.named_parameters()), net)


def opt_state_to_jax(state: OptState, net: PointCloudNet) -> OptState:
    """The port's :class:`~repro_torch.train.OptState` → the numpy form of
    the JAX ``OptState``: ``mu`` and ``nu`` as parameter-shaped trees and
    ``step`` a 0-d int32 array, under the same field names (the inverse of
    :func:`opt_state_from_jax`)."""
    return OptState(mu=_host_tree(state.mu, net), nu=_host_tree(state.nu, net),
                    step=np.asarray(state.step, np.int32))


def lm_params_from_jax(tree: Mapping, cfg: ModelConfig, device="cuda",
                       dtype=None) -> dict:
    """The numpy form of a JAX LM parameter tree → the port's parameter
    dict on ``device`` in ``dtype`` (default ``cfg.dtype``), shapes checked.
    bf16 leaves go through fp32, which holds them exactly. Every block
    and FFN kind converts (attention, Mamba, mLSTM, sLSTM; dense and MoE
    with its shared expert); the shapes are the port's own init tree's
    (``transformer.param_shapes``)."""
    dtype = dtype or cfg.param_dtype

    def load(node, shapes, path):
        if isinstance(shapes, dict):
            missing = set(shapes) - set(node)
            if missing:
                raise ValueError(f"{path or 'tree'}: missing {sorted(missing)}")
            return {k: load(node[k], s, f"{path}/{k}" if path else k)
                    for k, s in shapes.items()}
        return _tensor(node, shapes, path, device, dtype)

    return load(tree, param_shapes(cfg), "")


def lm_opt_state_from_jax(state, cfg: ModelConfig, device="cuda",
                          dtype=torch.float32) -> OptState:
    """The numpy form of a JAX LM ``OptState`` (``mu``, ``nu`` trees in the
    parameters' nesting, ``step``) → the port's
    :class:`~repro_torch.train.OptState` on ``device``, moments in
    ``dtype`` (the reference's ``state_dtype``, fp32 by default)."""
    return OptState(mu=lm_params_from_jax(state.mu, cfg, device, dtype),
                    nu=lm_params_from_jax(state.nu, cfg, device, dtype),
                    step=int(np.asarray(state.step)))


def lm_params_to_jax(params: Mapping) -> dict:
    """The port's LM parameter tree → the numpy form of the JAX tree (host
    copies; bf16 leaves as fp32, which holds them exactly: cast with
    ``jnp.asarray(a, jnp.bfloat16)`` to get the reference's arrays)."""
    return {k: lm_params_to_jax(v) if isinstance(v, Mapping)
            else _host(v.float() if v.dtype == torch.bfloat16 else v)
            for k, v in params.items()}


def lm_opt_state_to_jax(state: OptState) -> OptState:
    """The port's LM :class:`~repro_torch.train.OptState` → the numpy form
    of the JAX ``OptState``: ``mu`` and ``nu`` trees, ``step`` a 0-d int32
    array (the inverse of :func:`lm_opt_state_from_jax`)."""
    return OptState(mu=lm_params_to_jax(state.mu),
                    nu=lm_params_to_jax(state.nu),
                    step=np.asarray(state.step, np.int32))
