"""The device mesh of a multi-GPU count.

Counterpart of ``krust_tpu/parallel/mesh.py``. Two forms:

- **One process, every local GPU** (no process group, the default): as
  ``krust_tpu`` drives every local chip from one process, one process
  counts on every GPU it can see, one table slot per device; the slots
  exchange in process (:mod:`krust_tpu_torch.parallel.sharded`). A mesh may
  also be built from an explicit device list, repeats allowed: slots that
  share a device are the port's counterpart of XLA's virtual host devices
  (CPU tests, several slots on one card).
- **One process per GPU** (``torchrun --nproc-per-node N``, after
  :func:`init_distributed`): one rank is one process on one device,
  joined by ``torch.distributed``; the port's multi-host form, where
  ``krust_tpu`` calls ``jax.distributed``. A rank drives one device: c10d's
  NCCL drives one device per process.

A :class:`Mesh` is one process's view of either.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """One process's view of the mesh.

    ``group`` is the process group the exchange runs on, None for a mesh
    of one process (its slots exchange in process); ``size`` is the number
    of table slots across the whole mesh, ``rank`` this process's rank,
    ``device`` its first device and ``devices`` its devices, one per local
    slot (``(device,)`` when not given).
    """

    group: object | None
    size: int
    rank: int
    device: torch.device
    devices: tuple = ()

    def __post_init__(self):
        if not self.devices:
            object.__setattr__(self, "devices", (self.device,))


def _indexed(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without an index is
    the current one, so that a slot's device equals its tensors'."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _local_device(device) -> torch.device:
    """``device`` when given, else this rank's GPU, ``cuda:LOCAL_RANK``."""
    if device is not None:
        return _indexed(device)
    _require_cuda()
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def _require_cuda() -> None:
    """No CPU fallback: without CUDA the caller must name the device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the sharded count runs on a GPU unless "
            "EngineConfig(device=...) names another device"
        )


def make_mesh(n_devices: int | None = None, device=None, devices=None) -> Mesh:
    """This process's mesh.

    Without a process group: the first ``n_devices`` of ``devices``, one
    slot each; ``devices`` defaults to every visible GPU, or to ``device``
    alone when one is named (a mesh of one). Asking for more devices than
    there are raises ``ValueError``.

    In a process group (:func:`init_distributed`): every rank, one device
    each (``device``, else ``cuda:LOCAL_RANK``); ``n_devices``, when given,
    must equal the world size. Several devices per rank raise
    ``NotImplementedError``.
    """
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"requested {n_devices} devices")
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        if (devices is not None and len(devices) > 1) or (
            n_devices is not None and n_devices > size
        ):
            raise NotImplementedError(
                "several devices per rank of a process group (ROADMAP Queue C, "
                "stated differences): start one process per GPU, or count in one "
                "process with no process group"
            )
        if n_devices is not None and n_devices != size:
            raise ValueError(
                f"requested {n_devices} devices, the world has {size} ranks of one device each"
            )
        dev = _local_device(devices[0] if devices else device)
        return Mesh(dist.group.WORLD, size, rank, dev)
    if devices is not None:
        avail = tuple(_indexed(d) for d in devices)
    elif device is not None:
        avail = (_indexed(device),)
    else:
        _require_cuda()
        avail = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    if n_devices is not None:
        if n_devices > len(avail):
            raise ValueError(f"requested {n_devices} devices, only {len(avail)} available")
        avail = avail[:n_devices]
    if not avail:
        raise ValueError("a mesh needs at least one device")
    return Mesh(None, len(avail), 0, avail[0], avail)


def init_distributed(coordinator: str | None = None, **kwargs) -> None:
    """Join the default process group: NCCL when CUDA is available, gloo
    otherwise (``backend=`` overrides).

    ``coordinator`` is an ``init_method`` (``tcp://host:port``,
    ``file:///path``; a bare ``host:port`` means TCP); None reads the
    environment ``torchrun`` sets. Other keywords (``rank``,
    ``world_size``, ...) pass to ``torch.distributed.init_process_group``.
    Before NCCL, the process selects its GPU, ``LOCAL_RANK``. One process
    on one host's GPUs need not call this.
    """
    backend = kwargs.pop("backend", None) or (
        "nccl" if torch.cuda.is_available() else "gloo"
    )
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if coordinator is not None and "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=coordinator, **kwargs)
