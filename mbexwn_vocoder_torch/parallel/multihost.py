"""Joining a group of training processes, one per card.

Counterpart of the JAX package's parallel/multihost.py.  Every process calls
`initialize()` with the same address and world size and its own rank, or
with none of them under torchrun, which sets `MASTER_ADDR`, `MASTER_PORT`,
`WORLD_SIZE`, `RANK` and `LOCAL_RANK`.  The backend follows the device the
process trains on: NCCL for the card, gloo for the CPU.  There is no switch
from one to the other: asking for NCCL on a host without a card raises, and
a caller that wants gloo on card tensors (two ranks sharing one card, which
NCCL refuses) passes `backend="gloo"`.  `LOCAL_RANK` picks the rank's card.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from ..platform import platform_device, resolve_device

# how long a rank waits for the others to join, or for a collective, before
# it fails instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now, for the group
    address of ranks this process spawns."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def local_rank() -> int:
    return _env_int("LOCAL_RANK") or 0


def initialize(master_addr: Optional[str] = None, world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None, device: Union[str, torch.device, None] = None) -> bool:
    """Join the process group.  `master_addr` is "host:port" (default
    `MASTER_ADDR`:`MASTER_PORT`), `world_size` and `rank` default to
    `WORLD_SIZE` and `RANK`.  `device` is the device this rank trains on
    (default: `MBEXWN_PLATFORM`'s, the card unless it says cpu; a bare
    "cuda" becomes `cuda:LOCAL_RANK`, which is made the current card).
    Returns False when there is nothing to join (no world size given or in
    the environment), True once joined."""
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if world_size is None:
        return False
    if rank is None:
        rank = _env_int("RANK") or 0
    if master_addr is None:
        master_addr = f"{os.environ.get('MASTER_ADDR', 'localhost')}:{os.environ.get('MASTER_PORT', '29500')}"
    dev = platform_device() if device is None else resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise RuntimeError(f"the nccl backend needs a card; this rank runs on {dev}")
    dist.init_process_group(backend, init_method=f"tcp://{master_addr}", world_size=world_size, rank=rank,
                            timeout=TIMEOUT, device_id=dev if backend == "nccl" else None)
    return True


def process_info() -> Dict:
    """This process's place in the group (rank 0 of 1 outside one)."""
    joined = dist.is_available() and dist.is_initialized()
    return {"rank": dist.get_rank() if joined else 0, "world_size": dist.get_world_size() if joined else 1,
            "local_rank": local_rank(), "backend": dist.get_backend() if joined else None,
            "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 0}


def shutdown() -> None:
    """Leave the process group (nothing when not in one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
