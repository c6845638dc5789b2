"""First-class sparse tensor: features + packed coords + count + layout
(torch port of ``repro.core.sparse_tensor``).

Row contract: ``packed[: count]`` strictly ascending and deduplicated,
``packed[count:]`` PAD; ``features[i]`` belongs to ``packed[i]`` and PAD
rows carry zero features. The constructors establish it host-side (numpy
sort + unique, the one-time packing step) and then place the tensors on
``device``.

Batching writes the scene index into the most-significant ``bb`` bits, so
a batched sorted array is the scene-ordered concatenation of the per-scene
sorted arrays; round-down never clears batch bits and the guard band keeps
offset queries inside their scene (the JAX module doc gives the lemmas).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .packing import BitLayout, pack, unpack
from .validate import ValidationError, ValidationReport, validate_point_cloud
from .voxel import pad_value


def _session_hint(got: str) -> str:
    return (f"expected a SparseTensor, got {got}. Build one with "
            "SparseTensor.from_point_cloud(coords, features, layout) or "
            "SparseTensor.from_point_clouds([...]) and run it through a "
            "session: repro_torch.serve.compile_network(net, layout)(st).")


def ensure_sparse_tensor(x, *, where: str = "this API"):
    """Raise an actionable TypeError unless ``x`` is a SparseTensor."""
    if not isinstance(x, SparseTensor):
        raise TypeError(f"{where}: {_session_hint(type(x).__name__)}")
    return x


def _pack_np(coords: np.ndarray, layout: BitLayout,
             batch: Optional[np.ndarray]) -> np.ndarray:
    b = None if batch is None else torch.from_numpy(batch)
    return pack(torch.from_numpy(np.ascontiguousarray(coords)), layout,
                b).numpy()


def _padded(p: np.ndarray, f: np.ndarray, capacity: Optional[int], what: str):
    n = p.shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} {what}")
    pb = np.full((cap,), pad_value(p.dtype), p.dtype)
    pb[:n] = p
    fb = np.zeros((cap, f.shape[-1]), f.dtype)
    fb[:n] = f
    return pb, fb


@dataclasses.dataclass
class SparseTensor:
    """Features [cap, C] + packed coords [cap] + valid-row count + layout."""

    features: torch.Tensor
    packed: torch.Tensor
    count: torch.Tensor      # int32 0-d tensor on packed's device
    layout: BitLayout
    validation: Optional[ValidationReport] = dataclasses.field(
        default=None, compare=False)

    # -- shape facts ------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.packed.shape[0]

    @property
    def channels(self) -> int:
        return self.features.shape[-1]

    @property
    def num_scenes(self) -> int:
        """Scene slots the layout can address (1 for single-scene)."""
        return 1 << self.layout.bb

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def to(self, device) -> "SparseTensor":
        """The same tensor on ``device`` (no copy if already there)."""
        return dataclasses.replace(self, features=self.features.to(device),
                                   packed=self.packed.to(device),
                                   count=self.count.to(device))

    # -- constructors (host-side; the one-time packing step) --------------

    @classmethod
    def from_point_cloud(cls, coords, features, layout: BitLayout, *,
                         capacity: Optional[int] = None, scene_id: int = 0,
                         validate: str = "reject",
                         device="cuda") -> "SparseTensor":
        """One scene: guard-biased integer ``coords`` [N, 3] and aligned
        ``features`` [N, C] → sorted, deduplicated SparseTensor (duplicates
        keep the first occurrence). ``validate`` is the ingest policy of
        ``core.validate``; the report rides on ``st.validation``."""
        p, f, report = cls._pack_scene(coords, features, layout, scene_id,
                                       validate)
        pb, fb = _padded(p, f, capacity, "unique voxels")
        return cls._from_host(pb, fb, p.shape[0], layout, report, device)

    @classmethod
    def from_point_clouds(cls, clouds: Sequence[Tuple[np.ndarray, np.ndarray]],
                          layout: BitLayout, *,
                          capacity: Optional[int] = None,
                          validate: str = "reject",
                          device="cuda") -> "SparseTensor":
        """Pack B scenes ``[(coords, features), ...]`` into one batched
        SparseTensor through the batch bits (``layout.bb`` grows to fit B).
        Scene i's rows are the i-th contiguous segment; a rejected scene
        re-raises with ``scene_index`` set."""
        B = len(clouds)
        if B == 0:
            raise ValueError("from_point_clouds needs at least one scene")
        if (1 << layout.bb) < B:
            layout = layout.with_batch(B)
        ps, fs, report = [], [], None
        for i, (c, f) in enumerate(clouds):
            try:
                p, ff, rep = cls._pack_scene(c, f, layout, i, validate)
            except ValidationError as e:
                raise ValidationError(f"scene {i}: {e}", report=e.report,
                                      scene_index=i) from e
            ps.append(p)
            fs.append(ff)
            report = rep if report is None else report.merged(rep)
        p = np.concatenate(ps)
        f = np.concatenate(fs)
        pb, fb = _padded(p, f, capacity, "total voxels")
        return cls._from_host(pb, fb, p.shape[0], layout, report, device)

    @staticmethod
    def _pack_scene(coords, features, layout: BitLayout, scene_id: int,
                    validate: str):
        coords = np.asarray(coords)
        features = np.asarray(features)
        if coords.ndim != 2 or coords.shape[-1] != 3:
            raise ValueError(f"coords must be [N, 3] voxel ints, "
                             f"got {coords.shape}")
        if features.shape[0] != coords.shape[0]:
            raise ValueError(f"features rows ({features.shape[0]}) must match "
                             f"coords rows ({coords.shape[0]})")
        if scene_id and not layout.bb:
            raise ValueError(f"scene_id={scene_id} needs batch bits; use "
                             "layout.with_batch(B) (bb is 0)")
        coords, features, report = validate_point_cloud(
            coords, features, layout, policy=validate)
        b = (np.full(coords.shape[0], scene_id, np.int64)
             if layout.bb else None)
        p = _pack_np(np.asarray(coords, np.int64), layout, b)
        p, first = np.unique(p, return_index=True)
        return p, features[first], report

    @classmethod
    def _from_host(cls, pb, fb, n, layout, report, device) -> "SparseTensor":
        return cls(features=torch.from_numpy(fb).to(device),
                   packed=torch.from_numpy(pb).to(device),
                   count=torch.tensor(n, dtype=torch.int32, device=device),
                   layout=layout, validation=report)

    # -- padding / splitting ---------------------------------------------

    def pad_to(self, capacity: int) -> "SparseTensor":
        """Grow the buffer to ``capacity`` (PAD coords, zero features)."""
        if capacity == self.capacity:
            return self
        if capacity < self.capacity:
            raise ValueError(f"pad_to({capacity}) below current capacity "
                             f"{self.capacity}")
        extra = capacity - self.capacity
        pb = torch.cat([self.packed, torch.full(
            (extra,), pad_value(self.packed.dtype), dtype=self.packed.dtype,
            device=self.device)])
        fb = torch.cat([self.features, self.features.new_zeros(
            (extra, self.channels))])
        return SparseTensor(features=fb, packed=pb, count=self.count,
                            layout=self.layout, validation=self.validation)

    def scene_segments(self) -> Tuple[np.ndarray, np.ndarray]:
        """(starts, counts) of each scene's row segment, host-side numpy,
        shape [num_scenes]; empty scene slots have count 0."""
        S = self.num_scenes
        n = int(self.count)
        p = self.packed[:n].cpu().numpy()
        sid = p.astype(np.int64) >> self.layout.shift_b
        starts = np.searchsorted(sid, np.arange(S), side="left")
        ends = np.searchsorted(sid, np.arange(S), side="right")
        return starts.astype(np.int32), (ends - starts).astype(np.int32)

    def unbatch(self) -> List["SparseTensor"]:
        """Split into per-scene tensors (batch bits cleared, single-scene
        layout), on this tensor's device."""
        base = dataclasses.replace(self.layout, bb=0)
        starts, counts = self.scene_segments()
        p = self.packed.cpu().numpy()
        f = self.features.cpu().numpy()
        bmask = (1 << self.layout.shift_b) - 1
        out = []
        for s, c in zip(starts, counts):
            pp = (p[s: s + c].astype(np.int64) & bmask).astype(base.np_dtype)
            buf = np.full((max(int(c), 1),),
                          pad_value(base.dtype), pp.dtype)
            buf[: c] = pp
            fb = np.zeros((max(int(c), 1), self.channels), f.dtype)
            fb[: c] = f[s: s + c]
            out.append(SparseTensor._from_host(buf, fb, int(c), base, None,
                                               self.device))
        return out

    def coords(self) -> Tuple[np.ndarray, np.ndarray]:
        """Unpacked (coords [count, 3], scene_ids [count]) of the valid
        prefix, host-side (guard bias still applied)."""
        n = int(self.count)
        c, b = unpack(self.packed[:n].cpu(), self.layout)
        return c.numpy(), b.numpy()
