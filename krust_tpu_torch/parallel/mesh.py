"""The device mesh of a multi-GPU count: one process per device.

Counterpart of ``krust_tpu/parallel/mesh.py``. Where JAX drives a mesh of
chips from one process, the port follows PyTorch's idiom: one rank is one
process on one device (``torchrun --nproc-per-node N``), joined by
``torch.distributed``. A :class:`Mesh` is one rank's view of that world. A
world of one needs no process group at all.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh.

    ``group`` is the process group the exchange runs on, None for a world
    of one without one (the exchange then runs no collective); ``size`` is
    the world size, ``rank`` this process's rank, ``device`` its device.
    """

    group: object | None
    size: int
    rank: int
    device: torch.device


def _local_device(device) -> torch.device:
    """``device`` when given, else this rank's GPU, ``cuda:LOCAL_RANK``.
    No CPU fallback: without CUDA the caller must name the device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the sharded count runs on a GPU unless "
            "EngineConfig(device=...) names another device"
        )
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """This rank's mesh: every rank of the default process group (when one
    is initialized; else a world of one), one device each.

    ``n_devices``, when given, must equal the world size: a rank counts on
    one device, so the mesh is as large as the world.
    """
    if dist.is_available() and dist.is_initialized():
        group, size, rank = dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    else:
        group, size, rank = None, 1, 0
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"requested {n_devices} devices, the world has {size} ranks of one device each"
        )
    return Mesh(group, size, rank, _local_device(device))


def init_distributed(coordinator: str | None = None, **kwargs) -> None:
    """Join the default process group: NCCL when CUDA is available, gloo
    otherwise (``backend=`` overrides).

    ``coordinator`` is an ``init_method`` (``tcp://host:port``,
    ``file:///path``; a bare ``host:port`` means TCP); None reads the
    environment ``torchrun`` sets. Other keywords (``rank``,
    ``world_size``, ...) pass to ``torch.distributed.init_process_group``.
    Before NCCL, the process selects its GPU, ``LOCAL_RANK``. A world of one
    need not call this.
    """
    backend = kwargs.pop("backend", None) or (
        "nccl" if torch.cuda.is_available() else "gloo"
    )
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if coordinator is not None and "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=coordinator, **kwargs)
