"""Synthetic voxel scenes from a seed: the benchmark's own copy of the
program's recipe (``data/scenes.py``: outdoor sweeps with a rough ground,
object shells and radial thinning; batches that share an ``overlap``
fraction of a base scene), with the program's coordinate features and
geometric labels. Plain numpy, so the inputs do not move when the program
changes its generator.

Coordinates are guard-biased integers (``GUARD`` added to every axis), as
the program's packing contract wants them.
"""
from __future__ import annotations

import numpy as np

GUARD = 16


def _unique(coords: np.ndarray, extent: np.ndarray) -> np.ndarray:
    coords = coords[(coords >= 0).all(1) & (coords < extent).all(1)]
    return np.unique(coords, axis=0)


def _surface_plane(rng, extent, axis: int, level: int, density: float):
    dims = [d for d in range(3) if d != axis]
    g = np.stack(np.meshgrid(np.arange(extent[dims[0]]),
                             np.arange(extent[dims[1]]), indexing="ij"), -1)
    g = g.reshape(-1, 2)
    g = g[rng.random(len(g)) < density]
    out = np.zeros((len(g), 3), np.int64)
    out[:, dims[0]] = g[:, 0]
    out[:, dims[1]] = g[:, 1]
    out[:, axis] = level + rng.integers(0, 2, len(g))
    return out


def _surface_sphere(rng, center, radius, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return np.round(center + v * radius).astype(np.int64)


def _surface_box(rng, corner, size, density):
    pts = []
    for axis in range(3):
        for side in (0, size[axis] - 1):
            face = _surface_plane(rng, np.array(size), axis, 0, density)
            face[:, axis] = side
            pts.append(face + corner)
    return np.concatenate(pts)


def outdoor_scene(seed: int, extent, n_objects: int = 24,
                  thin: float = 0.35) -> np.ndarray:
    """One LiDAR-like sweep: unique guard-biased int32 coords [N, 3]."""
    rng = np.random.default_rng(seed)
    ext = np.asarray(extent)
    pts = [_surface_plane(rng, ext, 2, 0, thin * 0.5)]
    center = ext[:2] // 2
    for _ in range(n_objects):
        c = np.array([rng.integers(32, ext[0] - 32),
                      rng.integers(32, ext[1] - 32), rng.integers(2, 10)])
        if rng.random() < 0.5:
            pts.append(_surface_sphere(rng, c, rng.integers(4, 14), 2000))
        else:
            size = rng.integers(6, 28, 3)
            size[2] = min(size[2], ext[2] - c[2] - 2)
            pts.append(_surface_box(rng, c, size, 0.9))
    coords = np.concatenate(pts)
    r = np.linalg.norm(coords[:, :2] - center, axis=1)
    keep = rng.random(len(coords)) < 1.0 / (1.0 + r / (ext[0] / 8))
    return (_unique(coords[keep], ext) + GUARD).astype(np.int32)


KINDS = {"outdoor": outdoor_scene}


def scene_group(seed: int, n: int, kind: str, extent, overlap: float):
    """``n`` scenes that each keep an ``overlap`` share of one base scene's
    voxels and add their own (consecutive sweeps share static geometry)."""
    if not 0.0 <= overlap <= 1.0:
        raise ValueError(f"overlap {overlap} outside [0, 1]")
    make = KINDS[kind]
    rng = np.random.default_rng(seed)
    base = make(seed, extent)
    out = []
    for b in range(n):
        own = make(seed + 101 + b, extent)
        keep = rng.random(len(base)) < overlap
        out.append(np.unique(np.concatenate([base[keep], own]),
                             axis=0).astype(np.int32))
    return out


def features(coords: np.ndarray, extent, channels: int) -> np.ndarray:
    """Normalised (x, y, z) and a constant channel, tiled to ``channels``."""
    c = (coords.astype(np.float32) - GUARD) / np.asarray(extent, np.float32)
    base = np.concatenate([c, np.ones((len(c), 1), np.float32)], axis=1)
    reps = -(-channels // base.shape[1])
    return np.ascontiguousarray(
        np.tile(base, (1, reps))[:, :channels], dtype=np.float32)


def labels(coords: np.ndarray, extent, n_classes: int) -> np.ndarray:
    """Height bands, and a last class for voxels hugging an x/y wall."""
    c = coords.astype(np.int64) - GUARD
    bands = max(n_classes - 1, 1)
    lab = np.clip((c[:, 2] * bands) // max(int(extent[2]), 1), 0, bands - 1)
    wall = ((c[:, 0] <= 1) | (c[:, 1] <= 1)
            | (c[:, 0] >= extent[0] - 2) | (c[:, 1] >= extent[1] - 2))
    return np.where(wall, n_classes - 1, lab).astype(np.int32)
