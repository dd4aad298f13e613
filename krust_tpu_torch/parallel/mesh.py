"""The device mesh of a multi-GPU count.

Counterpart of ``krust_tpu/parallel/mesh.py``. A mesh is table slots, one
per device (repeats allowed), over one or more processes:

- **One process, every local GPU** (no process group, the default): as
  ``krust_tpu`` drives every local chip from one process, one process
  counts on every GPU it can see, one table slot per device. A mesh may
  also be built from an explicit device list, repeats allowed: slots that
  share a device are the port's counterpart of XLA's virtual host devices
  (CPU tests, several slots on one card).
- **A process group** (after :func:`init_distributed`; ``torch.distributed``
  where ``krust_tpu`` calls ``jax.distributed``): each rank is one process
  that drives its share of its host's GPUs, one slot each, as
  ``krust_tpu``'s multi-host count drives ``n_dev / procs`` chips a
  process. Rank i of a host whose n ranks share g GPUs each drives
  ``cuda:i*g .. cuda:i*g+g-1``: one process per host (``torchrun
  --nproc-per-node 1``) drives every card of its host, one process per GPU
  (``--nproc-per-node <gpus>``) one card. Every rank drives as many slots.

Every form exchanges through :func:`krust_tpu_torch.parallel.sharded._exchange`.
A :class:`Mesh` is one process's view of the mesh.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..utils.config import default_device, forced_platform


@dataclass(frozen=True)
class Mesh:
    """One process's view of the mesh.

    ``group`` is the process group the exchange runs on, None for a mesh
    of one process; ``size`` is the number of table slots across the whole
    mesh (the ranks times each rank's slots), ``rank`` this process's rank,
    ``device`` its first device (the one its collectives run on) and
    ``devices`` its devices, one per local slot (``(device,)`` when not
    given).
    """

    group: object | None
    size: int
    rank: int
    device: torch.device
    devices: tuple = ()

    def __post_init__(self):
        if not self.devices:
            object.__setattr__(self, "devices", (self.device,))

    @property
    def world(self) -> int:
        """The number of processes: the mesh's slots over each rank's."""
        return self.size // len(self.devices)


def _indexed(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without an index is
    the current one, so that a slot's device equals its tensors'."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _local_devices() -> tuple:
    """This process's devices when none are named: one CPU slot when
    ``KRUST_PLATFORM=cpu`` asks for the CPU, else every visible GPU. No
    CPU fallback: without CUDA the caller must name the device or ask for
    the CPU."""
    if forced_platform() == "cpu":
        return (torch.device("cpu"),)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the sharded count runs on a GPU unless "
            "EngineConfig(device=...) names another device or KRUST_PLATFORM=cpu "
            "asks for the CPU"
        )
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def _host_rank(group) -> tuple[int, int]:
    """(this rank's place among its host's ranks, the host's ranks):
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` where ``torchrun`` set them,
    else one gather of the ranks' host names."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ.get("LOCAL_RANK", 0)), int(os.environ["LOCAL_WORLD_SIZE"])
    rank = dist.get_rank(group)
    names = [None] * dist.get_world_size(group)
    dist.all_gather_object(names, socket.gethostname(), group=group)
    mine = [r for r, name in enumerate(names) if name == names[rank]]
    return mine.index(rank), len(mine)


def _host_share(group) -> tuple:
    """This rank's share of its host's GPUs: rank i of the host's n ranks
    takes ``cuda:i*g .. cuda:i*g+g-1``, g the GPUs over n. A split that is
    uneven raises ``ValueError``: two ranks never drive one card. Under
    ``KRUST_PLATFORM=cpu`` every rank drives one CPU slot."""
    local = _local_devices()
    if local[0].type == "cpu":
        return local
    i, n = _host_rank(group)
    gpus = len(local)
    if gpus % n:
        raise ValueError(f"{gpus} GPUs do not split evenly over the host's {n} ranks")
    g = gpus // n
    return tuple(torch.device("cuda", i * g + j) for j in range(g))


def _rank_devices(n_devices, device, devices, world, group) -> tuple:
    """This process's slots (``make_mesh``'s rules); raises ``ValueError``
    when they cannot be had."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"requested {n_devices} devices")
    per_rank = None
    if n_devices is not None:
        if n_devices % world:
            raise ValueError(f"requested {n_devices} devices, not a multiple of the "
                             f"{world} ranks")
        per_rank = n_devices // world
    if devices is not None:
        avail = tuple(_indexed(d) for d in devices)
    elif device is not None:
        # in a group, n_devices slots all on the one named device
        avail = (_indexed(device),) * (per_rank if group is not None and per_rank else 1)
    elif group is not None:
        avail = _host_share(group)
    else:
        avail = _local_devices()
    if per_rank is not None:
        if per_rank > len(avail):
            raise ValueError(f"requested {n_devices} devices, only {len(avail) * world} "
                             "available")
        avail = avail[:per_rank]
    if not avail:
        raise ValueError("a mesh needs at least one device")
    return avail


def make_mesh(n_devices: int | None = None, device=None, devices=None) -> Mesh:
    """This process's mesh.

    Without a process group: the first ``n_devices`` of ``devices``, one
    slot each; ``devices`` defaults to every visible GPU (one CPU slot
    under ``KRUST_PLATFORM=cpu``), or to ``device`` alone when one is
    named (a mesh of one). Asking for more devices than there are raises
    ``ValueError``.

    In a process group (:func:`init_distributed`), a collective: every
    rank drives its host's GPUs shared evenly among the host's ranks
    (:func:`_host_share`), or ``devices`` (repeats allowed), or ``device``
    (one slot, or ``n_devices`` over the world's ranks, all on it).
    ``n_devices`` counts the slots of the whole mesh: the world size times
    each rank's slots, the first of each rank's devices. Ranks that would
    drive unequal numbers of slots raise ``ValueError``, every rank alike.
    """
    if not (dist.is_available() and dist.is_initialized()):
        avail = _rank_devices(n_devices, device, devices, 1, None)
        return Mesh(None, len(avail), 0, avail[0], avail)
    group = dist.group.WORLD
    world = dist.get_world_size(group)
    try:
        avail = _rank_devices(n_devices, device, devices, world, group)
        said = len(avail)
    except ValueError as e:
        said = str(e)
    # every rank learns every rank's slots, or its error, so all raise alike
    every = [None] * world
    dist.all_gather_object(every, said, group=group)
    errors = [f"rank {r}: {s}" for r, s in enumerate(every) if isinstance(s, str)]
    if errors:
        raise ValueError("; ".join(errors))
    if len(set(every)) > 1:
        raise ValueError(f"the ranks would drive {every} devices: every rank must drive "
                         "as many")
    return Mesh(group, world * said, dist.get_rank(group), avail[0], avail)


def init_distributed(coordinator: str | None = None, **kwargs) -> None:
    """Join the default process group: NCCL when CUDA is available and
    ``KRUST_PLATFORM=cpu`` does not ask for the CPU, gloo otherwise
    (``backend=`` overrides).

    ``coordinator`` is an ``init_method`` (``tcp://host:port``,
    ``file:///path``; a bare ``host:port`` means TCP); None reads the
    environment ``torchrun`` sets. Other keywords (``rank``,
    ``world_size``, ...) pass to ``torch.distributed.init_process_group``.
    With NCCL the process then selects its first device, ``cuda:i*g``
    (:func:`_host_share`); where ``torchrun`` did not set
    ``LOCAL_WORLD_SIZE``, the group also takes gloo for objects, so that
    the gather of host names runs before any GPU is selected. One process
    on one host's GPUs need not call this.
    """
    backend = kwargs.pop("backend", None) or (
        "nccl" if default_device().type == "cuda" else "gloo"
    )
    if backend == "nccl" and "LOCAL_WORLD_SIZE" not in os.environ:
        backend = "cpu:gloo,cuda:nccl"
    if coordinator is not None and "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=coordinator, **kwargs)
    if "nccl" in backend:
        torch.cuda.set_device(_host_share(dist.group.WORLD)[0])
