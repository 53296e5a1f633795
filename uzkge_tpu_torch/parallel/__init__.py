"""Process groups for the sharded proving path (parallel/sharded.py).

Counterpart of `uzkge_tpu/parallel/__init__.py`.  The JAX package turns its
mesh route on with UZKGE_MESH=1 over every visible device; here the caller
passes an explicit torch.distributed process group instead (KZG's `group=`),
one process per rank, every rank running the same program on its block of
the data, as shard_map's devices do.  NCCL groups take tensors on the card
(one card per rank), gloo groups tensors on the CPU; a tensor on the other
kind of device raises, it is never copied over.
"""

import datetime
import os

import torch
import torch.distributed as dist


def start_group(directory: str, rank: int, world_size: int, backend: str,
                timeout_s: float = 120.0):
    """Join the default process group as `rank` of `world_size` over a
    FileStore in `directory` (one file, which must not be left over from
    another group), with the given backend: "nccl" (rank r on card r) or
    "gloo" (the CPU).  Collectives that wait longer than `timeout_s` raise.
    Returns the group."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: want 'nccl' or 'gloo'")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    store = dist.FileStore(os.path.join(directory, "filestore"), world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def group_device(group) -> torch.device:
    """The device of the tensors that `group`'s collectives take: the current
    card for NCCL, the CPU for gloo."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"process group backend {backend!r}: want nccl or gloo")


def check_device(group, t: torch.Tensor, name: str):
    """Raise unless `t` lies on the kind of device `group`'s collectives take."""
    want = group_device(group)
    if t.device.type != want.type:
        raise ValueError(f"{name} on {t.device}: a {dist.get_backend(group)} group takes "
                         f"tensors on {want.type}")
