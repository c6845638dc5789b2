"""Device meshes and the process groups under them.

The port of ``repro/launch/mesh.py``: the production shapes (single-pod
16×16 ``("data", "model")`` and 2-pod 2×16×16 ``("pod", "data",
"model")``) and a host mesh over the ranks that exist, as
``torch.distributed`` ``DeviceMesh``es over whatever process group is
initialised. Two helpers start one: :func:`init_single`, a one-process
group for one card (NCCL) or the CPU (gloo), and :func:`init_fake`, a fake
group of N ranks (``torch.testing._internal.distributed.fake_pg``: every
collective returns at once and moves nothing) under which the dry run
builds production cells on the ``meta`` device in one process — the
counterpart of the reference's ``--xla_force_host_platform_device_count``.
Nothing on a machine tells a program of a cluster: a multi-process run
passes the address, world size and rank to
``torch.distributed.init_process_group`` itself.
"""
from __future__ import annotations

import socket

import torch.distributed as dist


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_single(device: str = "cuda") -> None:
    """A one-process group (rank 0 of 1): NCCL for ``cuda``, gloo for
    ``cpu``. Does nothing when a group is already initialised."""
    if dist.is_initialized():
        return
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)


def init_fake(world_size: int, rank: int = 0) -> None:
    """A fake group of ``world_size`` ranks in this one process (this
    process is ``rank``); collectives complete at once and carry nothing.
    For counting only (``dryrun``): tensors under it live on ``meta``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_mesh(shape, names, device_type: str = "cuda"):
    """A named ``DeviceMesh`` of ``shape`` over the initialised group, whose
    world size must equal the shape's product; on the card unless the
    caller asks for ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """A ``(world // model, model)`` ``("data", "model")`` mesh over the
    ranks that exist: ``(1, 1)`` on one card."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into a model axis of "
                         f"{model}")
    return make_mesh((n // model, model), ("data", "model"), device_type)


def parse_mesh(spec: str):
    """``"host"``, ``"16x16"``, ``"2x16x16"`` or any ``AxB`` / ``AxBxC``
    → ``(shape, axis names)``; ``None`` shape for ``host``."""
    if spec == "host":
        return None, ("data", "model")
    shape = tuple(int(n) for n in spec.split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
        len(shape))
    if names is None:
        raise ValueError(f"mesh {spec!r}: want host, AxB or AxBxC")
    return shape, names
