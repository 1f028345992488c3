"""Multi-process compression over a torch.distributed group: the port of
the JAX package's parallel/distributed.py.

Topology: a 2-level ("hosts", "chips") mesh, one host a process (a rank of
the group) and the chips the shards that process runs
(parallel/sharded.py). Blocks are the unit of data parallelism on both
axes, so the only collectives are:

  - an all-gather of the per-block compressed sizes, tails and flags (int32,
    one row a block), so every rank can lay out the RAP container;
  - an all-reduce of the totals (bytes in, bytes out).

Each rank feeds its local blocks and keeps its local chunks. Without a
group (or at world size 1) everything runs in one process, and a
("hosts", "chips") mesh is carved from the local device pool. The backend
is nccl on a card (its collectives take CUDA tensors on the rank's card)
and gloo on the CPU; a group that fails to form raises.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from . import sharded

#: how long a collective or the group's rendezvous may wait
TIMEOUT = datetime.timedelta(seconds=60)


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, *, device=None) -> None:
    """Join the process group (init_method e.g. "tcp://localhost:<port>"
    or "file://<path>") with a TIMEOUT: nccl for a CUDA device (None means
    cuda), on card rank % device count, and gloo for the CPU. A no-op when
    everything runs in one process (world_size None or 1)."""
    if world_size in (None, 1):
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size,
                            rank=rank, timeout=TIMEOUT)


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world() -> int:
    """The default group's world size, 1 without a group."""
    return dist.get_world_size() if _grouped() else 1


def make_host_chip_mesh(hosts: Optional[int] = None,
                        chips: Optional[int] = None, device=None,
                        devices=None) -> sharded.Mesh:
    """The ("hosts", "chips") mesh. hosts defaults to the group's world
    size (1 without a group); chips to the local device pool's size over
    the hosts in one process, or the whole pool a rank. In one process the
    hosts x chips shards are carved from the pool (sharded.device_pool:
    `devices`, the cards, or the CPU's virtual shards); in a group of
    several ranks, hosts must equal the world size and each rank holds its
    own row of chips, on its current card for a CUDA device. Asking for more
    shards than the pool holds raises ValueError."""
    world = _world()
    if world > 1 and devices is None and resolve_device(device).type == "cuda":
        devices = [torch.device("cuda", torch.cuda.current_device())]
    pool = sharded.device_pool(device, devices)
    n_hosts = hosts or world
    if world > 1 and n_hosts != world:
        raise ValueError(f"a {n_hosts}-host mesh in a group of {world} ranks")
    local_hosts = 1 if world > 1 else n_hosts
    n_chips = chips or max(1, len(pool) // local_hosts)
    need = local_hosts * n_chips
    if len(pool) < need:
        raise ValueError(f"need {need} devices for a {n_hosts}x{n_chips} "
                         f"mesh, have {len(pool)}")
    return sharded.Mesh(tuple(pool[:need]), (n_hosts, n_chips),
                        ("hosts", "chips"))


def compress_blocks_distributed(
        blocks_local: Sequence[bytes], block_size: int, mesh: sharded.Mesh,
        accel: int = 1, *,
        stats: Optional[dict] = None) -> Tuple[list, tuple, int]:
    """Compress this rank's local blocks over its chips of `mesh`, every
    shard at the global bucket `block_size`; returns (local chunks, the
    global (sizes, tails) tables as numpy int32, global block count).
    Flagged blocks are re-encoded on the host before the gather, so every
    rank's tables hold the final sizes. Every rank must hold the same
    number of blocks (else ValueError on every rank). stats, where given,
    receives the all-reduced "total_in" and "total_out". With a group (of
    any size) the tables and totals go through its collectives, on the
    rank's current card under nccl."""
    world = _world()
    if world > 1 and mesh.shape[0] != world:
        raise ValueError(f"mesh of {mesh.shape[0]} hosts in a group of "
                         f"{world} ranks")
    n_local = len(blocks_local)
    bodies, tails, flags = sharded.shard_blocks(
        blocks_local, lambda p, d, B: sharded.lz4_shard(p, accel, d, B),
        mesh.devices, block_size)
    table = torch.tensor([[len(b), t, f] for b, t, f
                          in zip(bodies, tails, flags)],
                         dtype=torch.int32).reshape(n_local, 3)
    totals = torch.tensor([sum(len(b) for b in blocks_local),
                           int(table[:, 0].sum())], dtype=torch.int64)
    if _grouped():
        cdev = (torch.device("cuda", torch.cuda.current_device())
                if dist.get_backend() == dist.Backend.NCCL
                else torch.device("cpu"))
        counts = torch.empty(world, dtype=torch.int64, device=cdev)
        dist.all_gather_into_tensor(
            counts, torch.tensor([n_local], dtype=torch.int64, device=cdev))
        if len(set(counts.tolist())) != 1:
            raise ValueError(f"ranks hold different block counts: "
                             f"{counts.tolist()}")
        gathered = torch.empty((world * n_local, 3), dtype=torch.int32,
                               device=cdev)
        dist.all_gather_into_tensor(gathered, table.to(cdev))
        totals = totals.to(cdev)
        dist.all_reduce(totals)
        table = gathered.cpu()
        totals = totals.cpu()
    if stats is not None:
        stats["total_in"], stats["total_out"] = (int(x) for x in totals)
    tab = table.numpy()
    return (bodies, (np.ascontiguousarray(tab[:, 0]),
                     np.ascontiguousarray(tab[:, 1])), world * n_local)
