"""Multi-process initialization on ``torch.distributed``.

Port of record: ``sqlp_tpu/parallel/distributed.py:25-64``. One process
is one rank; :func:`init_distributed` joins this process to the group at
``coordinator_address`` (``host:port`` of rank 0's TCP store), and
``parallel.mesh`` then lays a mesh over the ranks.

The backend follows from the layout, once, here:

* ``nccl`` when every rank has a GPU of its own;
* ``gloo`` when ranks share a card or run on the CPU (NCCL refuses two
  ranks on one GPU: "Duplicate GPU detected").

The ranks learn the layout from each other: the group first forms over
Gloo, each rank contributes a fingerprint of its device (host name and
the card's UUID, or "cpu"), and every rank takes the same decision from
the same gathered list. Under ``nccl`` the mesh's groups are created with
it (:func:`backend`); the Gloo world group only carries that exchange. A
failed initialization raises: no rank ever carries on alone.

The reference's ``cpu_devices_per_process`` forces virtual XLA devices;
torch has no such thing, so the port runs one rank per process and its
CLI refuses that flag.
"""

from __future__ import annotations

import datetime
import hashlib
import socket
from typing import Optional

import torch
import torch.distributed as dist

# the backend of the mesh's groups and a line that says why (set once)
_LAYOUT = {"backend": None, "summary": None, "timeout": None}


def _fingerprint(device: torch.device) -> int:
    """A 63-bit id of the physical device: equal for two ranks on one
    card (or both on the CPU of one host)."""
    if device.type == "cuda":
        uuid = getattr(torch.cuda.get_device_properties(device), "uuid",
                       None)
        ident = f"{socket.gethostname()}/cuda/" + (
            str(uuid) if uuid is not None else str(device.index))
    else:
        ident = f"{socket.gethostname()}/cpu"
    return int.from_bytes(hashlib.sha256(ident.encode()).digest()[:8],
                          "little") >> 1


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, device="cpu",
                     timeout_s: float = 600.0) -> str:
    """Join this process to the group as rank ``process_id`` of
    ``num_processes``, rank 0's store at ``coordinator_address``
    (``host:port``). ``device`` is the rank's device (``cuda:i`` or
    ``cpu``). Returns the backend of the mesh's groups. ``timeout_s``
    bounds every collective: a rank that waits longer raises."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, "
                         f"{num_processes})")
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    mine = torch.tensor([_fingerprint(device)], dtype=torch.int64)
    prints = [torch.zeros_like(mine) for _ in range(num_processes)]
    dist.all_gather(prints, mine)
    n_devices = len({int(p) for p in prints})
    if device.type == "cuda" and n_devices == num_processes:
        backend = "nccl"
        summary = f"{num_processes} ranks, each on a GPU of its own"
    else:
        backend = "gloo"
        where = str(device) if device.type == "cuda" else "the CPU"
        summary = (f"{num_processes} ranks share {where}"
                   if n_devices == 1 else
                   f"{num_processes} ranks on {n_devices} devices, some "
                   f"shared")
    _LAYOUT.update(backend=backend, summary=summary, timeout=timeout)
    return backend


def backend() -> Optional[str]:
    """The backend of the mesh's groups (None before initialization)."""
    return _LAYOUT["backend"]


def layout_summary() -> Optional[str]:
    """How the ranks sit on the devices, e.g. '2 ranks share cuda:0'."""
    return _LAYOUT["summary"]


def group_timeout() -> datetime.timedelta:
    return _LAYOUT.get("timeout") or datetime.timedelta(seconds=600)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown() -> None:
    """Leave the group (every rank calls it once, at the end)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _LAYOUT.update(backend=None, summary=None, timeout=None)
