"""Packed-native voxel coordinate codec (Spira §5.3), on torch tensors.

Port of ``repro.core.packing``: one (batch, x, y, z) tuple packs into one
int32 or int64 word; lexicographic order, offset addition (within the guard
band) and stride-2^m rounding (a bitwise AND) all act on the packed word.
See the JAX module for the guard-band contract; it is unchanged here.

Packed words wrap on purpose (``PAD + offset``): torch's int32/int64 adds
wrap in two's complement on the CPU and the GPU, as XLA's do.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch


def _batch_bits(batch: int) -> int:
    """Batch-field width for ``batch`` scenes (0 = batch-free layout)."""
    return 0 if batch <= 1 else max(1, int(np.ceil(np.log2(int(batch)))))


@dataclasses.dataclass(frozen=True)
class BitLayout:
    """Bit allocation (batch, x, y, z), most-significant field first.

    ``bits_total <= 31`` packs into int32 (sign bit clear), otherwise int64
    (``<= 63``). ``guard`` is the guard band the layout was sized for; real
    coordinates live in ``data_range()`` = ``[guard, 2^b - guard)``."""

    bx: int = 12
    by: int = 12
    bz: int = 8
    bb: int = 0  # batch bits (0 => single scene)
    guard: int = 16

    def __post_init__(self):
        if min(self.bx, self.by, self.bz) < 1 or self.bb < 0:
            raise ValueError(f"BitLayout needs bx/by/bz >= 1 and bb >= 0, "
                             f"got bx={self.bx} by={self.by} bz={self.bz} "
                             f"bb={self.bb}")
        if self.guard < 1 or self.guard & (self.guard - 1):
            raise ValueError(f"BitLayout guard must be a power of two >= 1, "
                             f"got {self.guard}")
        if self.bits_total > 63:
            raise ValueError(
                f"BitLayout too wide: bx={self.bx} + by={self.by} + "
                f"bz={self.bz} + bb={self.bb} = {self.bits_total} bits, but "
                f"64-bit packing keeps the sign bit clear (max 63).")

    @property
    def bits_total(self) -> int:
        return self.bb + self.bx + self.by + self.bz

    @property
    def dtype(self) -> torch.dtype:
        return torch.int32 if self.bits_total <= 31 else torch.int64

    @property
    def np_dtype(self):
        return np.int32 if self.bits_total <= 31 else np.int64

    @property
    def shift_z(self) -> int:
        return 0

    @property
    def shift_y(self) -> int:
        return self.bz

    @property
    def shift_x(self) -> int:
        return self.bz + self.by

    @property
    def shift_b(self) -> int:
        return self.bz + self.by + self.bx

    def capacity(self) -> Tuple[int, int, int, int]:
        """(batch, x, y, z) max representable exclusive bounds."""
        return (1 << self.bb if self.bb else 1, 1 << self.bx, 1 << self.by,
                1 << self.bz)

    def data_range(self) -> Tuple[Tuple[int, int], ...]:
        """Per-axis ``[guard, 2^b - guard)`` bounds of real coordinates."""
        g = self.guard
        return tuple((g, (1 << b) - g) for b in (self.bx, self.by, self.bz))

    @classmethod
    def for_extent(cls, ex: int, ey: int, ez: int, batch: int = 1,
                   guard: int = 16) -> "BitLayout":
        """Smallest layout covering a grid extent plus ``guard`` per side."""
        if guard < 1 or guard & (guard - 1):
            raise ValueError(f"guard must be a power of two, got {guard}")
        need = lambda n: max(1, int(np.ceil(np.log2(max(2, int(n) + 2 * guard)))))
        bits = {"x": need(ex), "y": need(ey), "z": need(ez)}
        bb = _batch_bits(batch)
        total = sum(bits.values()) + bb
        if total > 63:
            raise ValueError(
                f"BitLayout.for_extent({ex}, {ey}, {ez}, batch={batch}, "
                f"guard={guard}) needs {total} bits but packing allows at "
                f"most 63.")
        return cls(bx=bits["x"], by=bits["y"], bz=bits["z"], bb=bb,
                   guard=guard)

    def with_batch(self, batch: int) -> "BitLayout":
        """Same x/y/z fields, batch field sized for ``batch`` scenes."""
        return dataclasses.replace(self, bb=_batch_bits(batch))


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def pack(coords: torch.Tensor, layout: BitLayout,
         batch: torch.Tensor | None = None) -> torch.Tensor:
    """Pack ``coords[..., 3]`` (x, y, z >= 0) into one word; ``batch``
    (same leading shape) goes in the most-significant field. A raw encoder:
    no bounds check (``core.validate`` enforces the contract at ingest)."""
    dt = layout.dtype
    x = coords[..., 0].to(dt)
    y = coords[..., 1].to(dt)
    z = coords[..., 2].to(dt)
    out = (x << layout.shift_x) | (y << layout.shift_y) | (z << layout.shift_z)
    if batch is not None and layout.bb:
        out = out | (batch.to(dt) << layout.shift_b)
    return out


def pack_offsets(offsets, layout: BitLayout,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """Pack signed weight offsets so ``pack(q) + pack_offsets(d) ==
    pack(q + d)`` (borrows cancel per field). Packed on the host and kept
    on ``device`` once per (offsets, layout, device)
    (:func:`device_constant`): read-only, and no host-to-device copy after
    the first call."""
    o = np.asarray(offsets).astype(np.int64)
    packed = ((o[..., 0] << layout.shift_x) + (o[..., 1] << layout.shift_y)
              + (o[..., 2] << layout.shift_z))
    # the narrowing cast wraps, as the word type's own adds would
    word = np.int64 if layout.dtype == torch.int64 else np.int32
    return device_constant(packed.astype(word), layout.dtype,
                           device or "cpu")


def device_constant(values: np.ndarray, dtype: torch.dtype,
                    device: torch.device | str) -> torch.Tensor:
    """``values`` (host integers, e.g. an offset index set) as a ``dtype``
    tensor on ``device``, built once per (values, dtype, device) and shared
    by every caller: read-only, and no host-to-device copy after the first
    call (a CUDA-graph capture may make none, ``serve.session``)."""
    v = np.ascontiguousarray(values)
    return _constant(v.tobytes(), v.dtype.str, v.shape, dtype,
                     torch.device(device))


@functools.lru_cache(maxsize=None)
def _constant(raw: bytes, np_dtype: str, shape: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    v = np.frombuffer(raw, dtype=np_dtype).reshape(shape)
    return torch.as_tensor(v.copy(), device=device).to(dtype)


def unpack(packed: torch.Tensor, layout: BitLayout
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack`. Returns (coords[..., 3], batch), int32."""
    p = packed.to(layout.dtype)
    mask = lambda b: (1 << b) - 1
    z = (p >> layout.shift_z) & mask(layout.bz)
    y = (p >> layout.shift_y) & mask(layout.by)
    x = (p >> layout.shift_x) & mask(layout.bx)
    b = ((p >> layout.shift_b) & mask(layout.bb) if layout.bb
         else torch.zeros_like(x))
    return torch.stack([x, y, z], dim=-1).to(torch.int32), b.to(torch.int32)


# ---------------------------------------------------------------------------
# packed-native downsample rounding (Spira §5.3: bitwise mask)
# ---------------------------------------------------------------------------

def downsample_mask(layout: BitLayout, m: int) -> int:
    """Mask clearing the low ``m`` bits of each x/y/z field (Eq. 1)."""
    full = (1 << layout.bits_total) - 1
    clear = ((1 << m) - 1) << layout.shift_z
    clear |= ((1 << m) - 1) << layout.shift_y
    clear |= ((1 << m) - 1) << layout.shift_x
    return full & ~clear


def round_down(packed: torch.Tensor, layout: BitLayout, m: int) -> torch.Tensor:
    """Apply :func:`downsample_mask`. Not order-preserving: a sorted input
    splits into ``4^m`` interleaved sorted runs keyed by the cleared (x, y)
    residues (``repro.core.packing.round_down`` states the lemma)."""
    if m == 0:
        return packed
    return packed & downsample_mask(layout, m)


# ---------------------------------------------------------------------------
# offset enumeration Δ(K, s_p) with L1 norms and z-delta grouping
# ---------------------------------------------------------------------------

def offset_grid(K: int, stride: int = 1) -> np.ndarray:
    """All K³ offsets, each run of K forming one z-delta group (same (x, y),
    z ascending by ``stride``): row-major (x, y, z). int32 [K^3, 3]."""
    half = (K - 1) // 2
    r = (np.arange(K) - half) * stride
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1)
    return g.reshape(-1, 3).astype(np.int32)


def offset_l1(offsets: np.ndarray) -> np.ndarray:
    return np.abs(offsets).sum(axis=-1).astype(np.int32)
