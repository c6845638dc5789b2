"""Load the JAX package's parameters into the port's modules.

The JAX parameter tree of a point-cloud net is ``{layer: {"w", "b"},
"head"}``; taken to numpy with ``jax.tree.map(np.asarray, params)`` it is
plain arrays, which is all this module reads (it imports no JAX). With the
same weights in both packages, their outputs can be held against each
other.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.spconv import SpConv
from .models.pointcloud import PointCloudModel, PointCloudNet


def params_from_jax(tree: Mapping, net: PointCloudNet, *, device="cuda",
                    dtype=torch.float32) -> PointCloudModel:
    """The numpy form of a JAX parameter tree → a :class:`PointCloudModel`
    for ``net`` on ``device``. Shapes are checked against the specs."""
    def tensor(a, shape, what):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{what}: shape {a.shape}, expected {shape}")
        return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                            dtype=dtype)

    layers = {}
    for s in net.specs:
        p = tree[s.name]
        w = tensor(p["w"], (s.K ** 3, s.cin, s.cout), f"{s.name}.w")
        b = tensor(p["b"], (s.cout,), f"{s.name}.b") if s.bias else None
        layers[s.name] = SpConv(s, w, b)
    head = tensor(tree["head"], (net.specs[-1].cout, net.n_classes), "head")
    return PointCloudModel(net, layers, head)
