"""Multi-process coordination for pan-genome runs over torch.distributed.

Counterpart of the JAX `parallel/multihost.py`.  The reference's multi-node
story is Nextflow task scheduling over a shared filesystem
(`panHiTE.nf:94-129`, SURVEY.md §2.E).  Here every process runs the same
program in one `torch.distributed` process group, whole genomes are
partitioned round-robin across ranks (they share no state), and the
per-genome results are exchanged with one byte all-gather instead of files
on disk.

The caller creates the process group (`init_process_group` with its own
address, world size and rank); with NCCL it first calls
`torch.cuda.set_device(local_rank)`.  gloo gathers through host tensors,
NCCL through tensors on the rank's card.  Without a process group every
helper is the single-process identity, so the pan pipeline is the same
code either way.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, List, Optional, Sequence, TypeVar, Union

import torch
import torch.distributed as dist

T = TypeVar("T")


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _grouped() else 1


def process_index() -> int:
    return dist.get_rank() if _grouped() else 0


def init_from_env(device: Optional[Union[str, torch.device]] = None
                  ) -> bool:
    """Join the process group that torchrun's environment describes
    (WORLD_SIZE > 1, MASTER_ADDR / MASTER_PORT, RANK): NCCL after
    `torch.cuda.set_device(LOCAL_RANK)` when `device` is None or cuda,
    gloo for the CPU.  Returns False, doing nothing, outside such a launch
    or when a group already exists."""
    if _grouped() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://")
    return True


def partition(items: Sequence[T], pid: int | None = None,
              nproc: int | None = None) -> List[T]:
    """Round-robin slice of `items` owned by this process."""
    pid = process_index() if pid is None else pid
    nproc = process_count() if nproc is None else nproc
    return [x for i, x in enumerate(items) if i % nproc == pid]


def _comm_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_bytes(data: bytes) -> List[bytes]:
    """Gather one byte string from every process (order = rank).

    Two collectives: an all-gather of lengths, then an all-gather of the
    max-length-padded payloads (all_gather needs equal shapes)."""
    if not _grouped() or dist.get_world_size() == 1:
        return [data]
    dev = _comm_device()
    world = dist.get_world_size()
    n = torch.tensor([len(data)], dtype=torch.int64, device=dev)
    sizes = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(sizes, n)
    sizes = [int(s.item()) for s in sizes]
    buf = torch.zeros(max(max(sizes), 1), dtype=torch.uint8)
    if data:
        buf[: len(data)] = torch.frombuffer(bytearray(data),
                                            dtype=torch.uint8)
    buf = buf.to(dev)
    gathered = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(gathered, buf)
    return [g[:s].cpu().numpy().tobytes() for g, s in zip(gathered, sizes)]


def allgather_obj(obj: Any) -> List[Any]:
    """All-gather an arbitrary picklable object from every process."""
    return [pickle.loads(b) for b in allgather_bytes(pickle.dumps(obj))]


def merge_dicts(dicts: Sequence[dict]) -> dict:
    """Merge per-process dicts (disjoint keys expected; later wins)."""
    out: dict = {}
    for d in dicts:
        out.update(d)
    return out
