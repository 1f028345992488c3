"""Block data parallelism over several torch devices in one process: the
multi-device tier (MULTI), the port of the JAX package's
parallel/sharded.py (its mesh tier).

Blocks are the unit of data parallelism (fresh history per block), so a
batch is cut into contiguous shards of ceil(N / shards) blocks, placed as
the JAX mesh places rows, and each shard runs the single-device encoder on
its device. Every shard encodes at the whole batch's bucket B (and so the
same parse grid G, OUTCAP and MAXSEQ), which keeps the streams identical to
the single-device tier's, whatever the shard count. Results come back in
block order; per-block sizes and tails are host values, so no collective is
needed in one process (parallel/distributed.py adds torch.distributed).

Devices: a mesh lists one torch device per shard. A CUDA mesh holds
cuda:0 .. cuda:k-1; the CPU offers up to CPU_VIRTUAL_SHARDS virtual shards
(the JAX suite's xla_force_host_platform_device_count); an explicit
`devices` list may name one device several times (several shards on one
card). One worker thread runs per distinct device, and shards that share a
device run in sequence on it, each inside `torch.cuda.device(dev)`: the
hand kernels launch on the current device's current stream. A shard's
failure is raised, never caught.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import lz4_device
from ..utils.device import resolve_device

#: virtual shards the CPU offers (the JAX suite's 8 virtual CPU devices)
CPU_VIRTUAL_SHARDS = 8


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's shards: `devices` (one torch device per shard, row
    major), the mesh `shape` and its `axis_names`. A multi-process mesh
    lists only the local row of chips (parallel/distributed.py)."""
    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...] = ("blocks",)

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def _index(dev: torch.device) -> torch.device:
    """A CUDA device with its index (cuda means the current card), so
    shards on one card compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def device_pool(device=None, devices=None) -> List[torch.device]:
    """The devices shards may be placed on: `devices` as given, else every
    visible card for a CUDA device, else CPU_VIRTUAL_SHARDS virtual shards
    of the CPU."""
    if devices is not None:
        return [_index(resolve_device(d)) for d in devices]
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev] * CPU_VIRTUAL_SHARDS


def make_mesh(n_devices: Optional[int] = None, device=None,
              devices=None) -> Mesh:
    """A 1-D mesh ("blocks") of `n_devices` shards: cuda:0 .. cuda:k-1 with
    k = min(n, device count) for a CUDA device (None: every card); n
    virtual shards of the CPU (None: 1), raising ValueError past
    CPU_VIRTUAL_SHARDS; or the first n of an explicit `devices` list (None:
    all of it), raising ValueError past its length."""
    pool = device_pool(device, devices)
    if devices is None and pool[0].type == "cuda":
        n = min(n_devices or len(pool), len(pool))
    else:
        n = n_devices or (len(pool) if devices is not None else 1)
    if n > len(pool):
        raise ValueError(f"need {n} shards, have {len(pool)} devices; pass "
                         f"devices=[...] to place several shards on one")
    return Mesh(tuple(pool[:n]), (n,))


def _shard_mesh(num_shards, n_blocks: int, device, devices) -> Mesh:
    """The mesh a batch of n_blocks runs on: num_shards (None or 0: one
    shard a device of the default mesh), clamped to the devices and the
    blocks, as compress_blocks_mesh clamps it."""
    ndev = len(device_pool(device, devices))
    auto = make_mesh(None, device, devices).size
    return make_mesh(min(num_shards or auto, ndev, max(1, n_blocks)),
                     device, devices)


def split(items: Sequence, shards: int) -> List[list]:
    """Contiguous shards of ceil(n / shards) items, as the JAX mesh places
    the rows of a batch padded to a multiple of the shard count; shards
    that would hold only padding are left out."""
    per = -(-len(items) // shards)
    return [list(items[i:i + per]) for i in range(0, len(items), per)]


def _on(dev: torch.device):
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def run_shards(devices: Sequence[torch.device], fn: Callable,
               parts: Sequence) -> list:
    """[fn(parts[i], devices[i])] in shard order: one worker thread per
    distinct device, shards on one device in sequence, each inside
    torch.cuda.device(dev) on a card. An exception in any shard is
    raised here."""
    out = [None] * len(parts)
    by_dev = {}
    for i in range(len(parts)):
        by_dev.setdefault(devices[i], []).append(i)

    def run(idx):
        for i in idx:
            with _on(devices[i]):
                out[i] = fn(parts[i], devices[i])

    if len(by_dev) == 1:
        run(next(iter(by_dev.values())))
        return out
    with concurrent.futures.ThreadPoolExecutor(len(by_dev)) as ex:
        futures = [ex.submit(run, idx) for idx in by_dev.values()]
        for f in futures:
            f.result()
    return out


def _concat(results: list):
    """Per-shard results in block order; tuples member by member."""
    if isinstance(results[0], tuple):
        return tuple([x for r in results for x in r[k]]
                     for k in range(len(results[0])))
    return [x for r in results for x in r]


def shard_blocks(blocks: Sequence[bytes], encode_fn: Callable,
                 devices: Sequence[torch.device], bucket: int):
    """encode_fn(shard_blocks, shard_device, bucket) over contiguous shards
    of `blocks`, one a device of `devices`, concatenated in block order."""
    parts = split(blocks, len(devices))
    return _concat(run_shards(devices, lambda p, d: encode_fn(p, d, bucket),
                              parts))


def sharded_block_call(blocks: Sequence[bytes], encode_fn: Callable,
                       num_shards: Optional[int] = None, *, device,
                       devices=None):
    """The multi-device tier's wrapper for any ops-level encoder:
    encode_fn(shard_blocks, shard_device, bucket) returns per-block results
    (a list, or a tuple of lists) for its shard, at the whole batch's
    bucket; they are concatenated in block order. At one shard it is one
    call on the single device."""
    mesh = _shard_mesh(num_shards, len(blocks), device, devices)
    B = lz4_device._bucket(max(len(b) for b in blocks))
    return shard_blocks(blocks, encode_fn, mesh.devices, B)


def lz4_shard(blocks: Sequence[bytes], accel: int, device, bucket):
    """One shard of the lz4 encoder: (bodies, tails, flags), the flagged
    blocks re-encoded on the host tier (flags 1 there)."""
    from ..codecs.lz4 import reencode_flagged
    bodies, tails, flagged = lz4_device.encode_blocks(
        blocks, accel, device=device, bucket=bucket)
    reencode_flagged(blocks, bodies, tails, flagged, accel)
    flags = [0] * len(blocks)
    for i in flagged:
        flags[i] = 1
    return bodies, tails, flags


def compress_blocks_multi(blocks: Sequence[bytes], accel: int = 1,
                          num_shards: Optional[int] = None, *, device,
                          devices=None):
    """Multi-device lz4 batch encode behind the unified API: (bodies,
    tails) as codecs/lz4._device_bodies returns them, identical for any
    shard count. Each shard's chunks come back through compact.fetch_chunks
    on its device (the compact_rows kernel on a card), where the JAX mesh
    tier copies the whole (N, OUTCAP) body buffer to the host: the bytes
    are the same, and the audit names the fetch once per shard."""
    lz4_device.check_block_sizes(blocks)
    bodies, tails, _ = sharded_block_call(
        blocks, lambda p, d, B: lz4_shard(p, accel, d, B), num_shards,
        device=device, devices=devices)
    return bodies, tails


def decompress_blocks_multi(chunks: Sequence[bytes], dlens: Sequence[int],
                            block_size: int,
                            num_shards: Optional[int] = None, *, device,
                            devices=None) -> List[bytes]:
    """Multi-device lz4 decode of RAP chunks, each shard at the whole
    batch's chunk and output buckets (C, B). Raises past 64 KiB, as the JAX
    mesh decoder does."""
    mesh = _shard_mesh(num_shards, len(chunks), device, devices)
    if mesh.size <= 1:
        return lz4_device.decode_blocks(chunks, dlens, block_size,
                                        device=mesh.devices[0])
    if max(dlens, default=0) > lz4_device.MAX_DEVICE_BLOCK:
        raise ValueError("device decode: block exceeds the 64 KiB limit")
    C = lz4_device._bucket(max((len(c) for c in chunks), default=1))
    B = lz4_device._bucket(max(max(dlens), block_size))
    parts = split(list(zip(chunks, dlens)), mesh.size)
    return _concat(run_shards(
        mesh.devices,
        lambda p, d: lz4_device.decode_blocks(
            [c for c, _ in p], [n for _, n in p], block_size, device=d,
            bucket=(C, B)), parts))


def _encode_rows(arr: np.ndarray, lens: np.ndarray, B: int, device):
    """The exact-parse encoder (G = 0) on rows of a padded batch on
    `device`: (bodies fetched through the compaction, sizes, tails)."""
    from ..ops import compact
    out, sizes, tails, _ = lz4_device.make_encoder(B, 0)(
        torch.from_numpy(arr).to(device), torch.from_numpy(lens).to(device))
    return (compact.fetch_chunks(out, sizes), sizes.cpu().numpy(),
            tails.cpu().numpy())


def make_step(block_size: int, mesh: Mesh):
    """The mesh's full step, as make_training_step: step(blocks (N, B)
    uint8, lens (N,) int32) -> (bodies, sizes (N,), tails (N,),
    total_bytes, total_in), every block's results in block order; the two
    totals are sums over the shards' own sums (the psum's stand-in)."""
    B = block_size

    def step(blocks, lens):
        arr = np.ascontiguousarray(np.asarray(blocks, dtype=np.uint8))
        ln = np.asarray(lens, dtype=np.int32)
        if arr.shape != (len(ln), B):
            raise ValueError(f"blocks must be (N, {B}) with lens (N,)")
        rows = split(range(len(ln)), len(mesh.devices))
        res = run_shards(mesh.devices, lambda r, d: _encode_rows(
            arr[r[0]:r[-1] + 1], ln[r[0]:r[-1] + 1], B, d), rows)
        bodies = [x for r in res for x in r[0]]
        total_bytes = sum(int(r[1].sum()) for r in res)
        total_in = sum(int(ln[r[0]:r[-1] + 1].sum()) for r in rows)
        return (bodies, np.concatenate([r[1] for r in res]),
                np.concatenate([r[2] for r in res]), total_bytes, total_in)

    return step


def compress_sharded(data: bytes, block_size: int,
                     mesh: Optional[Mesh] = None):
    """Host-facing sharded compress (the exact parse): (bodies, tails)
    per block. mesh None: make_mesh() (every card)."""
    from .container import split_blocks
    mesh = mesh or make_mesh()
    blocks = split_blocks(data, block_size)
    arr = np.zeros((len(blocks), block_size), dtype=np.uint8)
    lens = np.zeros(len(blocks), dtype=np.int32)
    for i, b in enumerate(blocks):
        arr[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i] = len(b)
    bodies, _, tails, _, _ = make_step(block_size, mesh)(arr, lens)
    return bodies, [int(t) for t in tails]
