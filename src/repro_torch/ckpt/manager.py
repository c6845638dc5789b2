"""Fault-tolerant checkpoints (torch port of ``repro.ckpt.manager``):
atomic writes, keep-last-k, async save, checksummed restore with
fallback.

Checkpoint + manifest format (version 2, the JAX package's)
-----------------------------------------------------------
One checkpoint ``step`` is two files, written in this order:

* ``ckpt_{step:08d}.npz`` — one array per leaf, keyed
  ``"{group}::{path}"`` (groups ``params`` and ``opt``), the path being
  the leaf's ``/``-joined keys in a nested dict of tensors or arrays. The
  guarded trainer hands over its state nested as the JAX package's trees
  (``train.guard.checkpoint_trees``), so the keys are the reference's:
  ``params::stem/w``, ``opt::.mu/stem/w``, ``opt::.nu/stem/w``,
  ``opt::.step`` (0-d int32), float32 in the JAX shapes (``w`` is
  ``[K³, Cin, Cout]``, as the port holds it). The LM trainer hands over
  its parameter tree and AdamW state the same way
  (``train.loop.checkpoint_trees``); bf16 leaves land as the reference's
  do, as raw 2-byte ``|V2`` arrays.
* ``ckpt_{step:08d}.json`` — the manifest::

      {"step": int, "format": 2,
       "checksums": {"params::stem/w": crc32, ...},   # zlib.crc32 of each
       ...extra}                                      # array's C-order bytes

Both files go to a temp name + ``os.replace`` (atomic on POSIX), so a
preemption mid-write never corrupts an existing checkpoint — but one
*between* the two replaces leaves an orphan ``.npz`` with no manifest. The
manifest is therefore the commit record: a checkpoint is **complete** iff
its manifest exists, and :meth:`CheckpointManager.restore` treats a
manifest-less ``.npz`` as corrupt (:class:`CheckpointCorruptionError`).
``_gc`` removes both orphan kinds (``.npz`` without ``.json`` and vice
versa) once they are not the newest write in flight.

Integrity contract
------------------
``restore`` verifies every array against the manifest's CRC32 before it
writes anything (``verify=False`` opts out); any mismatch, unreadable file
or missing key raises :class:`CheckpointCorruptionError` naming the file
and the first bad key. ``restore(..., fallback=True)`` instead walks back
to the **newest checkpoint that verifies** (counting failures in
``verify_failures``). Manifests of format < 2 (no checksums) restore
without verification.

Restore writes in place: every array is copied into the template's own
tensor, on the template's device, so the ``nn.Module`` and ``Parameter``
objects a session and its trainer hold stay the ones they hold. It
returns ``(params, opt_state, step)`` as the reference does: trees of the
templates' shape whose tensor leaves are the templates' tensors and whose
other leaves (the optimizer's step) are the loaded arrays.

Reshard-on-load: a template leaf may be a DTensor (its own shard is
written in place), and ``restore(..., shardings=, opt_shardings=)`` — trees
of ``dist.NamedSharding`` in the templates' shape, the reference's
arguments — restores each leaf as a new DTensor of that sharding instead
(the template then only names the leaf, its dtype and shape; a ``meta``
tensor will do). A checkpoint is the whole array of every leaf whatever
mesh saved it, so it restores onto any mesh, or into plain tensors. Under
a process group of several ranks ``save`` gathers each DTensor leaf on
every rank (all ranks must call it) and rank 0 alone writes.

The ``last_good`` tag
---------------------
``mark_last_good(step)`` atomically records a step in ``last_good.json``.
The tagged checkpoint is **exempt from GC**; the training guard
(``train.guard``) advances it only after a checkpoint has been followed by
healthy steps, making it the rollback anchor.

Async writes
------------
``save`` takes its host snapshot before it returns — the port's tensors
are overwritten in place by the next step — and with ``async_save=True``
hands the snapshot to a daemon thread, which computes the checksums and
writes the files. The writer's exceptions are captured and re-raised as
:class:`CheckpointWriteError` from the next ``save()`` / ``wait()``.
"""
from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..dist.sharding import is_dtensor, whole
from ..obs import MetricsRegistry, default_registry, span

MANIFEST_FORMAT = 2
LAST_GOOD_FILE = "last_good.json"


class CheckpointError(RuntimeError):
    """Base class for typed checkpoint failures."""


class CheckpointNotFoundError(CheckpointError):
    """No checkpoint exists (at the requested step, or at all)."""

    def __init__(self, directory: str, step: Optional[int] = None):
        self.directory = directory
        self.step = step
        what = (f"step {step}" if step is not None else "any step")
        super().__init__(f"no checkpoint found for {what} in {directory!r}")


class CheckpointCorruptionError(CheckpointError):
    """A checkpoint failed integrity verification. Names the offending file
    and (when the failure is array-level) the first bad key."""

    def __init__(self, path: str, *, key: Optional[str] = None,
                 reason: str = "checksum mismatch"):
        self.path = path
        self.key = key
        self.reason = reason
        at = f" (first bad key: {key!r})" if key is not None else ""
        super().__init__(f"corrupt checkpoint {path!r}: {reason}{at}")


class CheckpointWriteError(CheckpointError):
    """A deferred async-save failure, re-raised on the next save()/wait()."""


def _walk(tree, prefix: str, out: dict) -> None:
    """The leaves of a nested dict by their ``/``-joined keys (module
    doc)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], f"{prefix}/{k}" if prefix else str(k), out)
    else:
        out[prefix] = tree


def _leaves(tree) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    _walk(tree, "", out)
    return out


def _rebuild(tree, prefix: str, leaves: dict):
    """``tree``'s nesting with the leaves taken from ``leaves`` by key."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, f"{prefix}/{k}" if prefix else str(k), leaves)
                for k, v in tree.items()}
    return leaves[prefix]


def _snapshot(leaf) -> np.ndarray:
    """A host copy no later in-place update can reach (on the CPU
    ``.cpu()`` would return the same storage); a DTensor's whole array.
    bf16 has no numpy type: its raw 2-byte elements go in as ``|V2``, as
    the reference's bf16 arrays land in an npz."""
    if isinstance(leaf, torch.Tensor):
        host = whole(leaf).detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view("V2")
        return host.numpy()
    return np.array(leaf)


def _from_host(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor, ``|V2`` elements read as bf16 (``_snapshot``)."""
    if arr.dtype.kind == "V" and like.dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _rank() -> int:
    """This process's rank in the default group (0 without one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _place(arr: np.ndarray, like: torch.Tensor, sharding) -> torch.Tensor:
    """``arr`` in ``like``'s dtype as a DTensor: with ``sharding`` (a
    ``dist.NamedSharding``) on its mesh's device, else as ``like`` is
    placed; each rank keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor
    t = _from_host(arr, like).to(like.dtype)
    if sharding is not None:
        mesh, placements = sharding.mesh, sharding.placements
        dev = (torch.device("cuda", torch.cuda.current_device())
               if mesh.device_type == "cuda" else torch.device("cpu"))
    else:
        mesh, placements = like.device_mesh, like.placements
        dev = like.to_local().device
    return distribute_tensor(t.to(dev), mesh, placements, src_data_rank=None)


def _crc(a: np.ndarray) -> int:
    """``zlib.crc32`` of the array's C-order bytes (the reference's
    ``crc32(ascontiguousarray(a).tobytes())``, without the copy)."""
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 metrics: Optional[MetricsRegistry] = None):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        # save/restore duration histograms + byte counters (obs); recording
        # is thread-safe, so the async writer participates
        self.metrics = metrics if metrics is not None else default_registry()
        self._thread: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self.verify_failures = 0      # checkpoints that failed verification
        # fault-injection seam (train.faults.preempt_between_files): called
        # after the .npz lands but before the manifest
        self._post_npz_hook: Optional[Callable[[int], None]] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, params, opt_state=None, extra: dict | None = None):
        """Snapshot to host memory now, write to disk off-thread (async).
        Raises :class:`CheckpointWriteError` if the *previous* async write
        failed (module doc)."""
        groups = {"params": _leaves(params)}
        if opt_state is not None:
            groups["opt"] = _leaves(opt_state)
        # The first device-to-host copy waits for the step's queued work on
        # the stream: the one sync a save adds. The copies are complete
        # before save returns, so the next step may overwrite the tensors.
        with span("ckpt/snapshot", self.metrics):
            blob = {g: {k: _snapshot(v) for k, v in leaves.items()}
                    for g, leaves in groups.items()}
        meta = {"step": step, **(extra or {})}
        self._join_writer()   # backpressure: at most one write in flight;
                              # also surfaces the previous write's error
        if _rank() != 0:
            return            # rank 0 writes the gathered arrays
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_captured, args=(step, blob, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, blob, meta)

    def _write_captured(self, step: int, blob: dict, meta: dict):
        """Async-writer target: capture, never swallow (module doc)."""
        try:
            self._write(step, blob, meta)
        except BaseException as e:           # noqa: BLE001 — deferred reraise
            self._write_error = e

    def _write_npz(self, tmp: str, arrays: dict) -> None:
        """The raw array write — a seam so fault tests can inject a failing
        writer (disk full, torn write) without touching real IO paths."""
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)

    def _write(self, step: int, blob: dict, meta: dict):
        path = os.path.join(self.dir, f"ckpt_{step:08d}.npz")
        tmp = path + ".tmp"
        arrays = {f"{group}::{k}": v for group, tree in blob.items()
                  for k, v in tree.items()}
        with span("ckpt/save", self.metrics):
            self._write_npz(tmp, arrays)
            os.replace(tmp, path)  # atomic
            if self._post_npz_hook is not None:
                self._post_npz_hook(step)
            meta = {**meta, "format": MANIFEST_FORMAT,
                    "checksums": {k: _crc(v) for k, v in arrays.items()}}
            mpath = os.path.join(self.dir, f"ckpt_{step:08d}.json")
            with open(mpath + ".tmp", "w") as f:
                json.dump(meta, f)
            os.replace(mpath + ".tmp", mpath)  # the commit record (module doc)
        self.metrics.counter("ckpt_bytes_written").inc(
            sum(int(v.nbytes) for v in arrays.values()))
        self._gc()

    def _join_writer(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._write_error is not None:
            e, self._write_error = self._write_error, None
            raise CheckpointWriteError(
                f"previous async checkpoint write failed: "
                f"{type(e).__name__}: {e}") from e

    def wait(self):
        """Block until the in-flight write lands; re-raise its failure."""
        self._join_writer()

    def _gc(self):
        """Keep the newest ``keep`` complete checkpoints plus the
        ``last_good`` tag's step; remove orphans of both kinds (module
        doc) — except the newest .npz, which may be a write whose manifest
        is still in flight."""
        keep_good = self.last_good_step()
        complete = self.complete_steps()
        victims = set(complete[: -self.keep] if self.keep else complete)
        npz = set(self._steps_with(".npz"))
        man = set(self._steps_with(".json"))
        victims |= man - npz                       # orphan manifests
        newest = max(npz) if npz else None         # manifest may be in flight
        victims |= {s for s in npz - man if s != newest}   # orphan npz
        for s in victims:
            if s == keep_good:
                continue
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.dir, f"ckpt_{s:08d}{ext}"))
                except FileNotFoundError:
                    pass

    # -- the last_good tag (module doc) -------------------------------------

    def mark_last_good(self, step: int) -> None:
        """Atomically tag ``step`` as the verified rollback anchor. Waits
        for any in-flight write first (the tag must never lead the data)."""
        self._join_writer()
        if step not in self.complete_steps():
            raise CheckpointNotFoundError(self.dir, step)
        p = os.path.join(self.dir, LAST_GOOD_FILE)
        with open(p + ".tmp", "w") as f:
            json.dump({"step": step}, f)
        os.replace(p + ".tmp", p)

    def last_good_step(self) -> Optional[int]:
        try:
            with open(os.path.join(self.dir, LAST_GOOD_FILE)) as f:
                return int(json.load(f)["step"])
        except (FileNotFoundError, ValueError, KeyError,
                json.JSONDecodeError):
            return None

    # -- load ---------------------------------------------------------------

    def _steps_with(self, ext: str) -> list[int]:
        out = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(ext) and len(f) == 13 + len(ext):
                try:
                    out.append(int(f[5:13]))
                except ValueError:
                    pass
        return sorted(out)

    def steps(self) -> list[int]:
        return self._steps_with(".npz")

    def complete_steps(self) -> list[int]:
        """Steps whose manifest landed — the restorable set (module doc)."""
        return sorted(set(self._steps_with(".npz"))
                      & set(self._steps_with(".json")))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: Optional[int], params_template,
                opt_template=None, shardings=None, opt_shardings=None, *,
                verify: bool = True, fallback: bool = False
                ) -> Tuple[Any, Any, int]:
        """Restore into the templates' own tensors, or with ``shardings`` /
        ``opt_shardings`` into new DTensors of those shardings (module
        doc: reshard-on-load).

        ``step=None`` restores the newest checkpoint. ``verify=True``
        (default) checks every array against the manifest CRC32 and raises
        :class:`CheckpointCorruptionError` (file + first bad key) on any
        mismatch, missing manifest, or unreadable npz. ``fallback=True``
        walks back — newest first, starting at ``step`` when given — to the
        newest checkpoint that verifies; every rejected candidate
        increments ``verify_failures``."""
        self._join_writer()   # a restore must see the last write (or its error)
        steps = self.steps()
        if step is not None and step not in steps:
            raise CheckpointNotFoundError(self.dir, step)
        candidates = sorted((s for s in steps if step is None or s <= step),
                            reverse=True)
        if not candidates:
            raise CheckpointNotFoundError(self.dir,
                                          step if step is not None else None)
        if not fallback:
            candidates = candidates[:1]
        err: Optional[CheckpointCorruptionError] = None
        for s in candidates:
            try:
                with span("ckpt/restore", self.metrics):
                    return self._restore_one(s, params_template, opt_template,
                                             shardings, opt_shardings,
                                             verify=verify)
            except CheckpointCorruptionError as e:
                self.verify_failures += 1
                if err is None:
                    err = e           # report the NEWEST failure
        assert err is not None
        if fallback and len(candidates) > 1:
            raise CheckpointCorruptionError(
                err.path, key=err.key,
                reason=f"{err.reason}; all {len(candidates)} candidate "
                       f"checkpoints failed verification") from err
        raise err

    def _restore_one(self, step: int, params_template, opt_template,
                     shardings, opt_shardings, *, verify: bool
                     ) -> Tuple[Any, Any, int]:
        path = os.path.join(self.dir, f"ckpt_{step:08d}.npz")
        mpath = os.path.join(self.dir, f"ckpt_{step:08d}.json")
        try:
            with open(mpath) as f:
                meta = json.load(f)
        except FileNotFoundError:
            if verify:
                raise CheckpointCorruptionError(
                    mpath, reason="manifest missing — the write was "
                                  "preempted between the .npz and its "
                                  "manifest (module doc); the .npz alone "
                                  "is unverifiable") from None
            meta = {"step": step}   # verify=False: trust the filename
        except (ValueError, json.JSONDecodeError) as e:
            raise CheckpointCorruptionError(
                mpath, reason=f"unreadable manifest ({e})") from e
        try:
            with np.load(path) as z:
                data = {k: z[k] for k in z.files}
        except FileNotFoundError:
            raise CheckpointNotFoundError(self.dir, step) from None
        except Exception as e:   # BadZipFile / truncated / mmap failures
            raise CheckpointCorruptionError(
                path, reason=f"unreadable npz ({type(e).__name__}: {e})"
            ) from e
        checksums = meta.get("checksums")
        if verify and checksums is not None:
            for k in sorted(checksums):
                if k not in data:
                    raise CheckpointCorruptionError(
                        path, key=k, reason="array listed in the manifest "
                                            "is missing from the npz")
                if _crc(data[k]) != checksums[k]:
                    raise CheckpointCorruptionError(path, key=k)

        # every array is found and shape-checked before the first copy, so
        # a rejected checkpoint leaves the templates untouched
        groups = [("params", params_template, shardings)]
        if opt_template is not None:
            groups.append(("opt", opt_template, opt_shardings))
        plan = []
        for group, template, placed in groups:
            placed = _leaves(placed) if placed is not None else {}
            for key, leaf in _leaves(template).items():
                arr = data.get(f"{group}::{key}")
                if arr is None:
                    raise CheckpointCorruptionError(
                        path, key=f"{group}::{key}",
                        reason="array required by the restore template is "
                               "missing from the npz")
                if tuple(arr.shape) != tuple(np.shape(leaf)):
                    raise CheckpointCorruptionError(
                        path, key=f"{group}::{key}",
                        reason=f"shape {tuple(arr.shape)} does not match "
                               f"the template's {tuple(np.shape(leaf))}")
                plan.append((group, key, leaf, arr, placed.get(key)))
        restored: Dict[str, dict] = {"params": {}, "opt": {}}
        with torch.no_grad():
            for group, key, leaf, arr, sharding in plan:
                if sharding is not None:
                    restored[group][key] = _place(arr, leaf, sharding)
                elif isinstance(leaf, torch.Tensor):
                    if is_dtensor(leaf):
                        leaf.copy_(_place(arr, leaf, None))
                    else:
                        leaf.copy_(_from_host(arr, leaf))
                    restored[group][key] = leaf
                else:
                    restored[group][key] = arr
        self.metrics.counter("ckpt_bytes_read").inc(
            sum(int(v.nbytes) for v in data.values()))
        opt = (None if opt_template is None
               else _rebuild(opt_template, "", restored["opt"]))
        return (_rebuild(params_template, "", restored["params"]), opt,
                int(meta.get("step", step)))
