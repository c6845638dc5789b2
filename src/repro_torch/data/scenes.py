"""Synthetic voxel scenes with genuine surface geometry.

The L1-Norm Density Property (Spira §4) only holds for coordinates sampled
from *continuous object surfaces* — uniformly random voxels would make the
hybrid dataflow pointless. This generator builds indoor-style scenes (walls,
floor, boxes, spheres) and outdoor-style scenes (ground plane + scattered
objects + sensor-style radial thinning), voxelizes them, and applies the
engine's guard-band bias (packing.py contract).
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from ..core.packing import BitLayout, pack
from ..core.voxel import pad_value

GUARD = 16


@dataclasses.dataclass(frozen=True)
class Scene:
    coords: np.ndarray       # int32 [N, 3], unique, guard-biased, >= GUARD
    layout: BitLayout
    extent: tuple
    labels: np.ndarray | None = None   # int32 [N] per-voxel class, aligned
                                       # with coords (scene_batch(labels=True))


def _unique(coords: np.ndarray, extent: np.ndarray) -> np.ndarray:
    coords = coords[(coords >= 0).all(1) & (coords < extent).all(1)]
    return np.unique(coords, axis=0)


def _surface_plane(rng, extent, axis: int, level: int, density: float):
    """A jittered planar surface (wall/floor)."""
    dims = [d for d in range(3) if d != axis]
    g = np.stack(np.meshgrid(np.arange(extent[dims[0]]),
                             np.arange(extent[dims[1]]), indexing="ij"), -1)
    g = g.reshape(-1, 2)
    keep = rng.random(len(g)) < density
    g = g[keep]
    out = np.zeros((len(g), 3), np.int64)
    out[:, dims[0]] = g[:, 0]
    out[:, dims[1]] = g[:, 1]
    out[:, axis] = level + rng.integers(0, 2, len(g))  # 1-voxel roughness
    return out


def _surface_sphere(rng, center, radius, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return np.round(center + v * radius).astype(np.int64)


def _surface_box(rng, corner, size, density):
    pts = []
    for axis in range(3):
        for side in (0, size[axis] - 1):
            ext = np.array(size)
            face = _surface_plane(rng, ext, axis, 0, density)
            face[:, axis] = side
            pts.append(face + corner)
    return np.concatenate(pts)


def indoor_scene(seed: int = 0, room: tuple = (200, 160, 48),
                 density: float = 0.7) -> Scene:
    """ScanNet-style room: 4 walls + floor + ceiling + furniture boxes."""
    rng = np.random.default_rng(seed)
    ext = np.asarray(room)
    pts = [
        _surface_plane(rng, ext, 2, 0, density),                # floor
        _surface_plane(rng, ext, 2, ext[2] - 2, density * 0.6), # ceiling
        _surface_plane(rng, ext, 0, 0, density),                # walls
        _surface_plane(rng, ext, 0, ext[0] - 2, density),
        _surface_plane(rng, ext, 1, 0, density),
        _surface_plane(rng, ext, 1, ext[1] - 2, density),
    ]
    for _ in range(6):  # furniture
        hi = np.minimum(40, ext - 8)
        size = rng.integers(6, hi, 3)
        size[2] = min(size[2], ext[2] - 4)
        corner = np.array([rng.integers(2, ext[0] - size[0] - 2),
                           rng.integers(2, ext[1] - size[1] - 2), 1])
        pts.append(_surface_box(rng, corner, size, density * 0.8))
    coords = _unique(np.concatenate(pts), ext)
    layout = BitLayout.for_extent(*ext, guard=GUARD)
    return Scene(coords=(coords + GUARD).astype(np.int32), layout=layout,
                 extent=tuple(ext))


def outdoor_scene(seed: int = 0, extent: tuple = (1024, 1024, 40),
                  n_objects: int = 24, thin: float = 0.35) -> Scene:
    """KITTI/Waymo-style sweep: rough ground + object shells, radially
    thinned like a spinning LiDAR (density falls with range)."""
    rng = np.random.default_rng(seed)
    ext = np.asarray(extent)
    ground = _surface_plane(rng, ext, 2, 0, thin * 0.5)
    pts = [ground]
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
    # radial thinning: keep probability ~ 1/(1 + r/scale)
    r = np.linalg.norm(coords[:, :2] - center, axis=1)
    keep = rng.random(len(coords)) < 1.0 / (1.0 + r / (ext[0] / 8))
    coords = _unique(coords[keep], ext)
    layout = BitLayout.for_extent(*ext, guard=GUARD)
    return Scene(coords=(coords + GUARD).astype(np.int32), layout=layout,
                 extent=tuple(ext))


def random_scene(seed: int, n: int, extent: tuple = (128, 128, 64)) -> Scene:
    """Uniform-random voxels — the *anti*-property control for tests."""
    rng = np.random.default_rng(seed)
    ext = np.asarray(extent)
    coords = _unique(rng.integers(0, ext, (n, 3)), ext)
    layout = BitLayout.for_extent(*ext, guard=GUARD)
    return Scene(coords=(coords + GUARD).astype(np.int32), layout=layout,
                 extent=tuple(ext))


def _make_scene(kind: str, seed: int, extent: tuple, **kw) -> Scene:
    if kind == "indoor":
        return indoor_scene(seed, room=extent, **kw)
    if kind == "outdoor":
        return outdoor_scene(seed, extent=extent, **kw)
    if kind == "random":
        return random_scene(seed, kw.pop("n", 2500), extent=extent)
    raise ValueError(f"unknown scene kind {kind!r}")


def semantic_labels(coords: np.ndarray, extent: tuple,
                    n_classes: int = 8) -> np.ndarray:
    """Deterministic per-voxel segmentation labels from scene geometry.

    Class ``n_classes−1`` is "boundary" (voxels hugging an x/y wall); the
    remaining classes are height bands. Purely a function of the (guard-
    biased) coordinates, so labels survive any sort/dedup of the voxel set
    and are learnable from coordinate-derived features
    (``train.pointcloud.scene_features``) — real-scan-like in being
    geometric and class-imbalanced, without shipping a dataset."""
    c = coords.astype(np.int64) - GUARD
    bands = max(n_classes - 1, 1)
    lab = np.clip((c[:, 2] * bands) // max(int(extent[2]), 1), 0, bands - 1)
    wall = ((c[:, 0] <= 1) | (c[:, 1] <= 1)
            | (c[:, 0] >= extent[0] - 2) | (c[:, 1] >= extent[1] - 2))
    return np.where(wall, n_classes - 1, lab).astype(np.int32)


def scene_batch(seed: int = 0, batch: int = 4, kind: str = "indoor",
                extent: tuple = (64, 48, 24), overlap: float = 0.5,
                labels: bool = False, n_classes: int = 8,
                **kw) -> list:
    """A batch of scenes over ONE shared extent/layout with *controlled
    cross-scene overlap* — the multi-scene input the batched plan pipeline
    wants to be tested against.

    All-disjoint scene batches are toys: real batches (consecutive LiDAR
    sweeps, rooms from one building) share most of their static geometry,
    so batched kernel maps must handle heavy coordinate collision across
    batch ids. Each scene here keeps an ``overlap`` fraction of a common
    base scene's voxels and adds its own fresh geometry (seed + scene
    index), so any pair of scenes shares roughly ``overlap²`` of the base.

    ``overlap=0`` gives fully independent scenes; ``overlap=1`` makes every
    scene a superset of the base. Single-scene generators
    (:func:`indoor_scene` etc.) are unchanged — this composes them.

    ``labels=True`` attaches per-voxel segmentation targets
    (:func:`semantic_labels` over ``n_classes``) to each scene — the
    training subsystem's data contract (``train.pointcloud``).
    """
    assert 0.0 <= overlap <= 1.0, overlap
    rng = np.random.default_rng(seed)
    base = _make_scene(kind, seed, extent, **kw)
    out = []
    for b in range(batch):
        own = _make_scene(kind, seed + 101 + b, extent, **kw)
        keep = rng.random(len(base.coords)) < overlap
        coords = np.unique(np.concatenate([base.coords[keep], own.coords]),
                           axis=0).astype(np.int32)
        lab = (semantic_labels(coords, base.extent, n_classes)
               if labels else None)
        out.append(Scene(coords=coords, layout=base.layout,
                         extent=base.extent, labels=lab))
    return out


def pack_scene(scene: Scene, capacity: int | None = None,
               device="cuda") -> torch.Tensor:
    """Pack (and pad to ``capacity``) scene coordinates → int tensor for
    ``build_coord_set``. This is the engine's one-time packing step."""
    p = pack(torch.from_numpy(scene.coords), scene.layout).numpy()
    cap = capacity or len(p)
    if cap < len(p):
        raise ValueError(f"capacity {cap} < {len(p)} voxels")
    out = np.full((cap,), pad_value(p.dtype), p.dtype)
    out[: len(p)] = p
    return torch.from_numpy(out).to(device)
