"""Fault injection for the training stack (torch port of
``repro.train.faults``): every failure mode the guarded trainer
(``train.guard``) defends against, made injectable and deterministic.

* **NaN/Inf poison past the ingest boundary** — :func:`poison_nonfinite`
  plants non-finite values into a *packed* SparseTensor's features. The
  ingest validator (``core.validate``, policy ``"reject"``) refuses
  non-finite features at construction, so faults of this class arise
  *after* validation (a device bit-flip, a buggy augmentation stage, an
  upstream kernel writing garbage). Exercises the all-finite flag and
  bisection quarantine.
* **Label poison** — :func:`poison_labels` plants finite out-of-range
  class ids. ``segmentation_loss`` clips them (wrong-but-finite loss), so
  these exercise the *spike detector*, not the non-finite flag.
* **On-disk checkpoint corruption** — :func:`corrupt_checkpoint`
  byte-flips or truncates a checkpoint's ``.npz`` in place; exercises
  CRC32 verify-on-restore and ``restore(fallback=True)``.
* **Preemption between the two atomic replaces** —
  :func:`preempt_between_files` arms the manager's ``_post_npz_hook`` so
  the next save dies after the ``.npz`` lands but before its manifest.
* **Failing writer** — :func:`fail_next_write` makes the next raw npz
  write raise; exercises the async writer's capture-and-reraise contract
  (:class:`~repro_torch.ckpt.CheckpointWriteError` from the next
  ``save()`` / ``wait()``).

The checkpoint faults act on files alone, so they corrupt a checkpoint
written by either package the same way. Nothing here is imported by the
hot path.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.sparse_tensor import SparseTensor


class PreemptionError(BaseException):
    """An injected preemption: the process dies *here*. Derives from
    BaseException (like KeyboardInterrupt) so that ordinary ``except
    Exception`` recovery code cannot swallow it — a real SIGKILL wouldn't
    be catchable at all."""


def poison_nonfinite(st: SparseTensor, rows: Sequence[int] = (0,),
                     col: int = 0, value: float = float("nan")
                     ) -> SparseTensor:
    """A copy of a packed SparseTensor with ``value`` (NaN by default) at
    ``features[rows, col]``. The packed rows and count are untouched, so
    the poison lands inside the valid prefix of whichever scene owns those
    rows and flows into the loss and every gradient."""
    feats = st.features.clone()
    feats[list(rows), col] = value
    return SparseTensor(features=feats, packed=st.packed, count=st.count,
                        layout=st.layout, validation=st.validation)


def poison_scene_nonfinite(st: SparseTensor, scene: int,
                           value: float = float("nan")) -> SparseTensor:
    """Non-finite poison aimed at one *scene* of a batched tensor: the
    first row of scene ``scene``'s segment."""
    starts, counts = st.scene_segments()
    if counts[scene] == 0:
        raise ValueError(f"scene {scene} is empty — nothing to poison")
    return poison_nonfinite(st, rows=(int(starts[scene]),), value=value)


def poison_labels(labels, rows: Sequence[int] = (0,),
                  value: int = 10 ** 6) -> torch.Tensor:
    """A copy of the labels with a finite out-of-range class id at
    ``rows``, on the labels' device: a wrong-but-finite loss for the
    spike detector."""
    lab = torch.as_tensor(labels).clone()
    lab[list(rows)] = value
    return lab


# -- on-disk checkpoint faults ------------------------------------------------

def corrupt_checkpoint(directory: str, step: int, *, mode: str = "flip",
                       key: Optional[str] = None) -> str:
    """Corrupt ``ckpt_{step:08d}.npz`` in place, manifest left intact.

    * ``mode="flip"`` — *silent* corruption: one byte of one array (``key``,
      default the first in sorted order) is XORed and the npz rewritten,
      so the zip container stays self-consistent and only the manifest's
      CRC32 can notice (naming the bad key).
    * ``mode="truncate"`` — torn write: the file is cut in half; the npz
      becomes unreadable at open.

    Returns the path."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    elif mode == "flip":
        with np.load(path) as z:
            data = {k: np.array(z[k]) for k in z.files}
        k = key if key is not None else sorted(data)[0]
        raw = bytearray(data[k].tobytes())
        raw[len(raw) // 2] ^= 0xFF
        data[k] = np.frombuffer(bytes(raw), data[k].dtype).reshape(
            data[k].shape)
        with open(path, "wb") as f:
            np.savez(f, **data)
    else:
        raise ValueError(f"mode must be 'flip' or 'truncate', got {mode!r}")
    return path


def preempt_between_files(mgr, *, once: bool = True) -> None:
    """Arm ``mgr`` so its next save is preempted *between* the ``.npz``
    replace and the manifest replace (:class:`PreemptionError` from the
    manager's ``_post_npz_hook`` seam), leaving the orphan-npz torn state.
    With ``once`` (default) the hook disarms itself. With async saves the
    preemption surfaces as a CheckpointWriteError on the next
    ``save()`` / ``wait()``."""
    def hook(step: int) -> None:
        if once:
            mgr._post_npz_hook = None
        raise PreemptionError(
            f"injected preemption after ckpt_{step:08d}.npz, before its "
            "manifest")
    mgr._post_npz_hook = hook


def fail_next_write(mgr, exc: Optional[BaseException] = None) -> None:
    """Make ``mgr``'s next raw npz write raise (``OSError('injected disk
    full')`` by default), then restore the real writer."""
    real = mgr._write_npz

    def failing(tmp, arrays):
        mgr._write_npz = real
        raise exc if exc is not None else OSError("injected disk full")

    mgr._write_npz = failing
