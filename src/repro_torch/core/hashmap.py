"""Hash-table kernel-map baseline (the TorchSparse/SpConv-style engine of
the paper's Figs. 2 and 10), torch port of ``repro.core.hashmap``.

Prior engines build a hash table over the input coordinates (the
pre-processing Spira removes) and resolve each query by probing. This is
an open-addressing table with linear probing, in plain torch: a yardstick,
not a main path.

* hash: the reference's 32-bit multiply-xorshift of the word's low 32
  bits, as uint32 arithmetic emulated in int64 with masks (torch has no
  uint32 multiply), so a key lands on the reference's slot.
* build: rounds of vectorised inserts. Every unplaced key writes its next
  probe slot with one scatter; where several keys target one empty slot
  the scatter keeps any one of them (on the card which one is not
  deterministic). The winners are decided by re-reading the slot, never
  by assuming an order, and the losers retry at the next slot. A slot
  never empties again, so every slot before a key's own on its probe
  chain is full, and a lookup finds the key wherever it landed: the
  table's layout may differ from the reference's, its kernel map may not.
* query: vectorised probe rounds, a query stopping at its key or at an
  empty slot.

Both loops are bounded by ``max_probes`` (64) as in the reference, and
stop early once every key is placed or every query resolved (one host
read per round).
"""
from __future__ import annotations

import numpy as np
import torch

from .voxel import CoordSet, pad_value

_LOW32 = 0xFFFFFFFF
_MULT1 = 0x9E3779B1     # 32-bit golden-ratio multiplier (Knuth)
_MULT2 = 0x85EBCA77


def _hash(keys: torch.Tensor, mask: int) -> torch.Tensor:
    """Slot of each key in a table of ``mask + 1`` slots (int64). The
    products of two 32-bit values wrap in int64, which keeps their low 32
    bits, the only ones the uint32 product has."""
    h = keys.to(torch.int64) & _LOW32
    h = (h * _MULT1) & _LOW32
    h = h ^ (h >> 15)
    h = (h * _MULT2) & _LOW32
    h = h ^ (h >> 13)
    return h & mask


def table_size_for(capacity: int) -> int:
    """Power-of-two table of at least twice the capacity (at least 16)."""
    return int(2 ** np.ceil(np.log2(max(16, 2 * capacity))))


def build_table(inputs: CoordSet, *, table_size: int, max_probes: int = 64
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Insert every valid coordinate; returns (table_keys [table_size],
    PAD where empty; table_vals int32, the key's row, −1 where empty)."""
    keys = inputs.packed
    dev = keys.device
    pad = pad_value(keys.dtype)
    ts = table_size
    vals = torch.arange(keys.shape[0], dtype=torch.int32, device=dev)
    live = keys != pad
    # one spare slot past the end takes the writes of keys already placed
    tkeys = torch.full((ts + 1,), pad, dtype=keys.dtype, device=dev)
    tvals = torch.full((ts + 1,), -1, dtype=torch.int32, device=dev)
    slot = _hash(keys, ts - 1)
    for _ in range(max_probes):
        if not bool(live.any()):
            break
        idx = torch.where(live, slot, ts)
        cand = tkeys.clone()
        cand[idx] = keys                      # one arbitrary winner a slot
        empty = tkeys == pad
        tkeys = torch.where(empty, cand, tkeys)
        tkeys[ts] = pad
        won = live & (tkeys[slot] == keys)    # re-read: who holds the slot
        tvals[torch.where(won, slot, ts)] = vals
        tvals[ts] = -1
        live = live & ~won
        slot = (slot + 1) & (ts - 1)
    return tkeys[:ts], tvals[:ts]


def hash_kernel_map(tkeys: torch.Tensor, tvals: torch.Tensor,
                    outputs: CoordSet, packed_offsets: torch.Tensor, *,
                    K: int, max_probes: int = 64) -> torch.Tensor:
    """Query phase: probe the table for every ``q_i + δ_k``; int32
    ``[M, K³]`` in the offsets' order, −1 for misses and PAD rows."""
    pad = pad_value(tkeys.dtype)
    ts = tkeys.shape[0]
    q = outputs.packed[:, None] + packed_offsets[None, :]      # wraps on PAD
    slot = _hash(q, ts - 1)
    found = torch.full(q.shape, -1, dtype=torch.int32, device=q.device)
    open_q = torch.ones(q.shape, dtype=torch.bool, device=q.device)
    for _ in range(max_probes):
        if not bool(open_q.any()):
            break
        k = tkeys[slot]
        hit = open_q & (k == q)
        found = torch.where(hit, tvals[slot], found)
        open_q = open_q & ~hit & (k != pad)
        slot = (slot + 1) & (ts - 1)
    valid_row = (outputs.packed != pad)[:, None]
    return torch.where(valid_row, found, -1)
