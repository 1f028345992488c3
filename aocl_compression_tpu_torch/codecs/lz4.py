"""LZ4 codec — block format, greedy fast compressor.

Tiers:
  HOST  — own C++ implementation (csrc/lz4_host.cpp) via ctypes.
  TORCH — the device encoder and decoder (ops/lz4_device.py) on the
          handle's device, compacted by the CUDA kernel in ops/compact.py.
  MULTI — the same encoder and decoder over several devices
          (parallel/sharded.py), handle.num_shards shards (0: one a card).
RAP decode runs on the host C++ decoder unless device decode is enabled
(utils.config.device_decode_enabled), the JAX package's default route.

Level semantics: LZ4 fast has no levels in the reference; the handle's
opt_var carries the acceleration factor (>=1), like LZ4_compress_fast.
opt_var >= 2 selects the device encoder.

The host routes of the device tiers are the JAX package's format routes,
each taken through the dispatch registry so the audit names it: blocks
over 64 KiB and chunks decoding to more than 64 KiB (16-bit position
packing), blocks the sort-emit encoder flags (re-encoded in
_device_bodies) and single-shot inputs under 1 KiB.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..api.handle import Handle
from ..parallel import container
from ..runtime import native
from ..utils import dispatch
from ..utils.config import (TIER_HOST, TIER_MULTI, TIER_TORCH,
                            device_decode_enabled, get_config)
from . import lz4_stitch
from .base import Codec

_MAX_ONESHOT_GROW = 1 << 30


class Lz4Codec(Codec):
    name = "lz4"
    version = "1.9.3-tpu"
    min_level, max_level, default_level = 0, 0, 0

    def compress_bound(self, n: int) -> int:
        cfg = get_config()
        return (native.lz4_compress_bound(n)
                + native.rap_frame_bound(n, cfg.default_block_size))

    def _block_size(self, handle: Handle) -> int:
        return handle.block_size or get_config().default_block_size

    def _rap_enabled(self, handle: Handle) -> bool:
        if handle.enable_rap is not None:
            return handle.enable_rap
        device = max(1, handle.opt_var) >= 2
        return get_config().enable_rap and not container.st_fallback(
            handle, device)

    def _adapter(self, handle: Handle) -> container.BlockCodecAdapter:
        accel = max(1, handle.opt_var)
        # the device pipeline is the throughput mode (tile-anchor parse);
        # accel<=1 keeps the serial-greedy ratio semantics on the host tier.
        # num_shards > 1 requests the multi-device tier (reference: MT
        # behind the same entry points, threads/threads.c:46)
        cap = (handle.max_tier if accel >= 2 or handle.num_shards > 1
               else TIER_HOST)
        cb, ctier = dispatch.resolve_with_tier(
            self.name, "compress_blocks", cap, handle.opt_off)
        if ctier == TIER_HOST:
            # host tier fans out over a thread pool (reference MT compress,
            # lz4.c:2655-2930); num_shards is the numThreads analog
            def compress(blocks):
                return cb(blocks, accel, workers=handle.num_shards or None)
        elif ctier == TIER_MULTI:
            def compress(blocks):
                return cb(blocks, accel, handle.device,
                          num_shards=multi_shards(handle),
                          mem_limit=handle.mem_limit or None)
        else:
            # mem_limit caps the input bytes per device batch; batching
            # happens BELOW the stitcher, so the stream layout is unchanged
            def compress(blocks):
                return cb(blocks, accel, handle.device,
                          mem_limit=handle.mem_limit or None)
        return container.BlockCodecAdapter(
            compress_blocks=compress,
            decompress_blocks=decompress_blocks_fn(handle,
                                                   self._block_size(handle)))

    def compress(self, handle: Handle, data: bytes) -> bytes:
        if self._rap_enabled(handle):
            out = container.compress_rapped(data, self._block_size(handle),
                                            self._adapter(handle))
            if out is not None:
                return out
        accel = max(1, handle.opt_var)
        fn, tier = dispatch.resolve_with_tier(
            self.name, "compress",
            handle.max_tier if accel >= 2 else TIER_HOST, handle.opt_off)
        if tier == TIER_HOST:
            return fn(data, accel)
        return fn(data, accel, handle.device)

    def decompress(self, handle: Handle, data: bytes,
                   expected_size: Optional[int] = None) -> bytes:
        out = container.decompress_rapped(data, self._adapter(handle))
        if out is not None:
            return out
        return _oneshot_decompress(data, expected_size)


def multi_shards(handle: Handle) -> Optional[int]:
    """The shard count a MULTI tier takes from the handle, as the JAX
    package's mesh tier takes it: num_shards per host times the hosts;
    None = one shard a device."""
    return handle.num_shards * max(1, handle.num_hosts) or None


def decompress_blocks_fn(handle: Handle, block_size: int):
    """RAP chunk decoder for lz4 and lz4hc streams: the device tiers on the
    handle's device when device decode is enabled, else the host tier."""
    cap = handle.max_tier if device_decode_enabled() else TIER_HOST
    db, tier = dispatch.resolve_with_tier("lz4", "decompress_blocks", cap,
                                          handle.opt_off)
    if tier == TIER_HOST:
        return lambda chunks, dlens: db(chunks, dlens, block_size,
                                        workers=handle.num_shards or None)
    if tier == TIER_MULTI:
        return lambda chunks, dlens: db(chunks, dlens, block_size,
                                        handle.device,
                                        num_shards=multi_shards(handle))
    return lambda chunks, dlens: db(chunks, dlens, block_size, handle.device)


def _oneshot_decompress(data: bytes, expected_size: Optional[int]) -> bytes:
    """Serial-safe decode. The block format has no size header; when the
    caller does not know the size, a structural token scan (C++, no byte
    movement) computes it exactly so the buffer is allocated once."""
    if expected_size is not None:
        return native.lz4_decompress(data, expected_size)
    size = native.lz4_decompressed_size(data)
    if size < 0 or size > _MAX_ONESHOT_GROW:
        raise ValueError("lz4 decompress: corrupt stream or oversized")
    return native.lz4_decompress(data, size)


# --- host-tier variants -------------------------------------------------------

@dispatch.register("lz4", "compress", TIER_HOST, "lz4_compress_host")
def _compress_host(data: bytes, accel: int) -> bytes:
    return native.lz4_compress(data, accel)


@dispatch.register("lz4", "compress_tail", TIER_HOST, "lz4_compress_tail_host")
def _compress_tail_host(data: bytes, accel: int):
    return native.lz4_compress_tail(data, accel)


@dispatch.register("lz4", "compress_blocks", TIER_HOST,
                   "lz4_compress_blocks_host")
def _compress_blocks_host(blocks: Sequence[bytes], accel: int, workers=None):
    from ..parallel import host_pool
    frags = host_pool.parallel_map(
        lambda b: native.lz4_compress_tail(b, accel), blocks,
        workers=workers, total_bytes=sum(len(b) for b in blocks))
    return lz4_stitch.stitch(frags, blocks)


@dispatch.register("lz4", "decompress_blocks", TIER_HOST,
                   "lz4_decompress_blocks_host")
def _decompress_blocks_host(chunks: Sequence[bytes], dlens: Sequence[int],
                            block_size: int, workers=None) -> List[bytes]:
    # parallel RAP fan-out — the reference's default MT decompress
    # (threads/threads.c:174-293, lz4.c:4785-4860)
    from ..parallel import host_pool
    return host_pool.parallel_map(
        lambda cd: native.lz4_decompress(cd[0], cd[1]) if cd[1] else b"",
        list(zip(chunks, dlens)), workers=workers,
        total_bytes=int(sum(dlens)))


# --- device-tier variants (ops/lz4_device.py) --------------------------------

def _device_bodies(blocks: Sequence[bytes], accel: int, device,
                   mem_limit=None, **params):
    """(bodies, tails) of `blocks` from the device encoder on `device`, one
    batch per group of <= mem_limit input bytes. Blocks the sort-emit
    encoder flags are re-encoded on the host tier (the JAX package's format
    route), with the stitcher's contract: a body excludes the final
    literal-only sequence."""
    from ..ops import lz4_device
    bodies, tails = [], []
    for g in container.block_groups(blocks, mem_limit):
        bo, ta, flagged = lz4_device.encode_blocks(g, accel, device=device,
                                                   **params)
        reencode_flagged(g, bo, ta, flagged, accel)
        bodies.extend(bo)
        tails.extend(ta)
    return bodies, tails


def reencode_flagged(blocks: Sequence[bytes], bodies: list, tails: list,
                     flagged: Sequence[int], accel: int) -> None:
    """Replace, in place, the body and tail of each block the sort-emit
    encoder flagged with the host tier's, under the stitcher's contract (a
    body excludes the final literal-only sequence)."""
    for i in flagged:
        stream, t = dispatch.resolve_host("lz4", "compress_tail")(
            blocks[i], max(accel, 1))
        bodies[i] = stream[:len(stream) - lz4_stitch.final_sequence_len(t)]
        tails[i] = t


@dispatch.register("lz4", "compress_blocks", TIER_TORCH,
                   "lz4_compress_blocks_torch")
def _compress_blocks_torch(blocks: Sequence[bytes], accel: int, device,
                           mem_limit=None):
    from ..ops import lz4_device
    if max(len(b) for b in blocks) > lz4_device.MAX_DEVICE_BLOCK:
        # 16-bit position packing
        return dispatch.resolve_host("lz4", "compress_blocks")(blocks, accel)
    return lz4_stitch.stitch_bodies(
        *_device_bodies(blocks, accel, device, mem_limit), blocks)


@dispatch.register("lz4", "compress", TIER_TORCH, "lz4_compress_torch")
def _compress_torch(data: bytes, accel: int, device) -> bytes:
    """Single-shot serial stream via the device pipeline: stitch the block
    fragments and join them without a RAP frame."""
    from ..ops import lz4_device
    bs = min(get_config().default_block_size, lz4_device.MAX_DEVICE_BLOCK)
    if len(data) < 1024:  # device dispatch overhead dwarfs tiny inputs
        return dispatch.resolve_host("lz4", "compress")(data, accel)
    blocks = container.split_blocks(data, bs)
    chunks, _ = lz4_stitch.stitch_bodies(
        *_device_bodies(blocks, accel, device), blocks)
    return b"".join(chunks)


@dispatch.register("lz4", "decompress_blocks", TIER_TORCH,
                   "lz4_decompress_blocks_torch")
def _decompress_blocks_torch(chunks: Sequence[bytes], dlens: Sequence[int],
                             block_size: int, device) -> List[bytes]:
    """Device decode of RAP chunks (see _device_or_host for the chunks
    decoding to more than 64 KiB)."""
    from ..ops import lz4_device
    return _device_or_host(chunks, dlens, block_size,
                           lambda c, d: lz4_device.decode_blocks(
                               c, d, block_size, device=device))


def _device_or_host(chunks: Sequence[bytes], dlens: Sequence[int],
                    block_size: int, decode) -> List[bytes]:
    """decode(chunks, dlens) of the chunks that decode to <= 64 KiB, the
    host tier for the others. A chunk decoding to more than 64 KiB (a
    stitched chunk carries its predecessor's tail literals) is past the
    JAX package's 16-bit packing limit, kept here as the format route. The
    JAX package's device tiers send the whole batch to the host then, the
    port's only such chunks, with the same bytes out."""
    from ..ops import lz4_device
    on_dev = [d <= lz4_device.MAX_DEVICE_BLOCK for d in dlens]
    out = [None] * len(chunks)
    for route in (True, False):
        idx = [i for i, ok in enumerate(on_dev) if ok == route]
        if not idx:
            continue
        sub_c, sub_d = [chunks[i] for i in idx], [dlens[i] for i in idx]
        res = (decode(sub_c, sub_d) if route
               else dispatch.resolve_host("lz4", "decompress_blocks")(
                   sub_c, sub_d, block_size))
        for i, r in zip(idx, res):
            out[i] = r
    return out


# --- multi-device variants (parallel/sharded.py) ------------------------------

@dispatch.register("lz4", "compress_blocks", TIER_MULTI,
                   "lz4_compress_blocks_multi")
def _compress_blocks_multi(blocks: Sequence[bytes], accel: int, device,
                           num_shards=None, mem_limit=None, devices=None):
    """The encoder sharded over devices (`devices`: an explicit shard
    list, as sharded.make_mesh takes it); mem_limit splits the batch into
    groups before sharding, as the JAX package's mesh tier does."""
    from ..ops import lz4_device
    from ..parallel import sharded
    if max(len(b) for b in blocks) > lz4_device.MAX_DEVICE_BLOCK:
        return dispatch.resolve_host("lz4", "compress_blocks")(blocks, accel)
    bodies, tails = [], []
    for g in container.block_groups(blocks, mem_limit):
        bo, ta = sharded.compress_blocks_multi(g, accel, num_shards,
                                               device=device, devices=devices)
        bodies.extend(bo)
        tails.extend(ta)
    return lz4_stitch.stitch_bodies(bodies, tails, blocks)


@dispatch.register("lz4", "decompress_blocks", TIER_MULTI,
                   "lz4_decompress_blocks_multi")
def _decompress_blocks_multi(chunks: Sequence[bytes], dlens: Sequence[int],
                             block_size: int, device, num_shards=None,
                             devices=None) -> List[bytes]:
    """The decoder sharded over devices (see _device_or_host for the
    chunks decoding to more than 64 KiB)."""
    from ..parallel import sharded
    return _device_or_host(chunks, dlens, block_size,
                           lambda c, d: sharded.decompress_blocks_multi(
                               c, d, block_size, num_shards, device=device,
                               devices=devices))
