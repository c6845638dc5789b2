"""What a cell feeds the program, made from ``--seed``: a pool of scene
batches (coordinates, features, labels) and the network's weights."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import scenes


@dataclasses.dataclass
class Batch:
    """One call's scenes: per scene guard-biased coords, features and
    (for training) labels."""

    coords: List[np.ndarray]
    feats: List[np.ndarray]
    labels: Optional[List[np.ndarray]] = None

    @property
    def voxels(self) -> int:
        return sum(len(c) for c in self.coords)


def pool(seed: int, mix: dict, cfg: dict) -> List[Batch]:
    """``mix["pool"]`` distinct batches of ``mix["scenes_per_call"]``
    scenes each; every batch is its own group of overlapping sweeps."""
    rng = np.random.default_rng(seed)
    group_seeds = rng.integers(0, 2 ** 31, size=mix["pool"])
    extent = tuple(mix["extent"])
    out = []
    for g in group_seeds:
        coords = scenes.scene_group(int(g), mix["scenes_per_call"],
                                    mix["kind"], extent, mix["overlap"])
        feats = [scenes.features(c, extent, cfg["in_channels"])
                 for c in coords]
        labels = ([scenes.labels(c, extent, cfg["n_classes"])
                   for c in coords] if mix["loop"] == "train" else None)
        out.append(Batch(coords, feats, labels))
    return out


def weights(layers: Sequence, cfg: dict, seed: int, device,
            dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Every parameter from one draw of a generator on ``device``:
    kernels ``N(0, 1 / (K^3 Cin))`` [K^3, Cin, Cout], the biases of the
    layers that have one and the head ``N(0, 0.02^2)``; named as the
    program names its parameters."""
    shapes = []
    for L in layers:
        k3 = L.K ** 3
        shapes.append((f"layers.{L.name}.weight", (k3, L.cin, L.cout),
                       (k3 * L.cin) ** -0.5))
        if L.bias:
            shapes.append((f"layers.{L.name}.bias", (L.cout,), 0.02))
    shapes.append(("head", (layers[-1].cout, cfg["n_classes"]), 0.02))
    sizes = [int(np.prod(s)) for _, s, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for (name, shape, scale), n in zip(shapes, sizes):
        out[name] = (flat[at:at + n] * scale).reshape(shape)
        at += n
    return out
