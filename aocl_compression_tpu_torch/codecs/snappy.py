"""Snappy codec — raw format.

Tiers:
  HOST  — own C++ snappy (csrc/snappy_host.cpp) via ctypes.
  TORCH — the device encoder and decoder (ops/snappy_device.py) on the
          handle's device, compacted by the CUDA kernel in ops/compact.py.
  MULTI — the device encoder over several devices (parallel/sharded.py).

RAP layout, as the reference's: the stream keeps one varint length
preamble, placed right after the RAP frame; chunks are raw element
streams (no per-chunk preamble), so their concatenation after
skip_rap_frame is one valid snappy stream for serial decoders.

opt_var >= 2 (or num_shards > 1) selects the device encoder; RAP decode
runs on the host unless device decode is enabled
(utils.config.device_decode_enabled). The host routes of the device tiers
are the JAX package's format routes, each taken through the dispatch
registry so the audit names it: blocks over 64 KiB, chunks of a batch with
any chunk decoding to more than 64 KiB, and blocks the sort-emit encoder
flags (re-encoded in _device_frags).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..api.handle import Handle
from ..ops.compact import _no_mark
from ..parallel import container
from ..runtime import native
from ..utils import dispatch
from ..utils.config import (TIER_HOST, TIER_MULTI, TIER_TORCH,
                            device_decode_enabled, get_config)
from .base import Codec
from .lz4 import multi_shards


def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _varint_len(data: bytes) -> int:
    for i, b in enumerate(data[:5]):
        if not (b & 0x80):
            return i + 1
    raise ValueError("bad varint")


def _strip_preamble(stream: bytes) -> bytes:
    return stream[_varint_len(stream):]


class SnappyCodec(Codec):
    name = "snappy"
    version = "2020-07-11-tpu"
    min_level, max_level, default_level = 0, 0, 0

    def compress_bound(self, n: int) -> int:
        cfg = get_config()
        return (native.snappy_max_compressed_length(n)
                + native.rap_frame_bound(n, cfg.default_block_size))

    def _block_size(self, handle: Handle) -> int:
        return handle.block_size or get_config().default_block_size

    def _adapter(self, handle: Handle) -> container.BlockCodecAdapter:
        accel = max(1, handle.opt_var)
        # device tier = throughput mode, engaged via opt_var (acceleration)
        # or a num_shards request
        cap = handle.max_tier if accel >= 2 or handle.num_shards > 1 \
            else TIER_HOST
        cb, ctier = dispatch.resolve_with_tier(
            self.name, "compress_blocks", cap, handle.opt_off)
        if ctier == TIER_HOST:
            def compress(blocks):
                return cb(blocks, accel, workers=handle.num_shards or None)
        elif ctier == TIER_MULTI:
            def compress(blocks):
                return cb(blocks, accel, handle.device,
                          num_shards=multi_shards(handle),
                          mem_limit=handle.mem_limit or None)
        else:
            # mem_limit caps the input bytes per device batch
            def compress(blocks):
                return cb(blocks, accel, handle.device,
                          mem_limit=handle.mem_limit or None)
        dcap = handle.max_tier if device_decode_enabled() else TIER_HOST
        db, dtier = dispatch.resolve_with_tier(
            self.name, "decompress_blocks", dcap, handle.opt_off)
        bs = self._block_size(handle)
        if dtier == TIER_HOST:
            def decompress(chunks, dlens):
                return db(chunks, dlens, bs,
                          workers=handle.num_shards or None)
        else:
            def decompress(chunks, dlens):
                return db(chunks, dlens, bs, handle.device)
        return container.BlockCodecAdapter(
            compress_blocks=compress, decompress_blocks=decompress,
            preamble=_varint)

    def compress(self, handle: Handle, data: bytes) -> bytes:
        rap = (handle.enable_rap if handle.enable_rap is not None
               else get_config().enable_rap and not container.st_fallback(
                   handle, max(1, handle.opt_var) >= 2))
        if rap:
            out = container.compress_rapped(data, self._block_size(handle),
                                            self._adapter(handle))
            if out is not None:
                return out
        fn = dispatch.resolve(self.name, "compress", handle.max_tier,
                              handle.opt_off)
        return fn(data)

    def decompress(self, handle: Handle, data: bytes,
                   expected_size: Optional[int] = None) -> bytes:
        out = container.decompress_rapped(data, self._adapter(handle))
        if out is not None:
            return out
        return native.snappy_uncompress(data)

    def uncompressed_length(self, data: bytes) -> int:
        """Parity with GetUncompressedLengthFromMTCompressedBuffer: reads the
        varint length, skipping a RAP frame if present (snappy.cc:596-604)."""
        return native.snappy_uncompressed_length(
            container.skip_rap_frame(data))


# --- host-tier variants -------------------------------------------------------

@dispatch.register("snappy", "compress", TIER_HOST, "snappy_compress_host")
def _compress_host(data: bytes) -> bytes:
    return native.snappy_compress(data)


@dispatch.register("snappy", "compress_blocks", TIER_HOST,
                   "snappy_compress_blocks_host")
def _compress_blocks_host(blocks: Sequence[bytes], accel: int = 1,
                          workers=None):
    # raw element fragments: compress each block, strip its varint preamble;
    # snappy elements are self-delimiting, so no boundary stitch is needed
    from ..parallel import host_pool
    frags = host_pool.parallel_map(
        lambda b: _strip_preamble(native.snappy_compress(b)), blocks,
        workers=workers, total_bytes=sum(len(b) for b in blocks))
    return frags, [len(b) for b in blocks]


@dispatch.register("snappy", "decompress_blocks", TIER_HOST,
                   "snappy_decompress_blocks_host")
def _decompress_blocks_host(chunks: Sequence[bytes], dlens: Sequence[int],
                            block_size: int, workers=None) -> List[bytes]:
    # parallel RAP fan-out (reference MT RawUncompress, snappy.cc:2282+)
    from ..parallel import host_pool
    return host_pool.parallel_map(
        lambda cd: native.snappy_uncompress(_varint(cd[1]) + cd[0]),
        list(zip(chunks, dlens)), workers=workers,
        total_bytes=int(sum(dlens)))


# --- device-tier variants (ops/snappy_device.py) ------------------------------

def _device_frags(blocks: Sequence[bytes], accel: int, device,
                  mem_limit=None, mark=_no_mark, bucket=None) -> List[bytes]:
    """Fragments of `blocks` from the device encoder on `device`, one batch
    per group of <= mem_limit input bytes. Blocks the sort-emit encoder
    flags are re-encoded on the host tier (the JAX package's format route).
    mark is the encoder's stage hook, bucket its batch bucket
    (ops/snappy_device.encode_blocks)."""
    from ..ops import snappy_device
    frags = []
    for g in container.block_groups(blocks, mem_limit):
        fr, flagged = snappy_device.encode_blocks(g, accel, device=device,
                                                  mark=mark, bucket=bucket)
        for i in flagged:
            fr[i] = _strip_preamble(
                dispatch.resolve_host("snappy", "compress")(g[i]))
        frags.extend(fr)
    return frags


@dispatch.register("snappy", "compress_blocks", TIER_TORCH,
                   "snappy_compress_blocks_torch")
def _compress_blocks_torch(blocks: Sequence[bytes], accel: int, device,
                           mem_limit=None):
    from ..ops import lz4_device
    if max(len(b) for b in blocks) > lz4_device.MAX_DEVICE_BLOCK:
        # 16-bit position packing
        return dispatch.resolve_host("snappy", "compress_blocks")(blocks,
                                                                  accel)
    return (_device_frags(blocks, accel, device, mem_limit),
            [len(b) for b in blocks])


@dispatch.register("snappy", "compress_blocks", TIER_MULTI,
                   "snappy_compress_blocks_multi")
def _compress_blocks_multi(blocks: Sequence[bytes], accel: int, device,
                           num_shards=None, mem_limit=None, devices=None):
    """The device encoder sharded over devices (`devices`: an explicit
    shard list), one sharded batch per group of <= mem_limit input
    bytes."""
    from ..ops import lz4_device
    from ..parallel import sharded
    if max(len(b) for b in blocks) > lz4_device.MAX_DEVICE_BLOCK:
        return dispatch.resolve_host("snappy", "compress_blocks")(blocks,
                                                                  accel)
    frags = []
    for g in container.block_groups(blocks, mem_limit):
        frags.extend(sharded.sharded_block_call(
            g, lambda p, d, B: _device_frags(p, accel, d, bucket=B),
            num_shards, device=device, devices=devices))
    return frags, [len(b) for b in blocks]


@dispatch.register("snappy", "decompress_blocks", TIER_TORCH,
                   "snappy_decompress_blocks_torch")
def _decompress_blocks_torch(chunks: Sequence[bytes], dlens: Sequence[int],
                             block_size: int, device) -> List[bytes]:
    """Device decode of RAP chunks. As in the JAX package, a batch with a
    chunk decoding to more than 64 KiB (16-bit offset packing) goes to the
    host tier whole; at block sizes <= 64 KiB every chunk stays on the
    device (snappy chunks are not stitched)."""
    from ..ops import lz4_device, snappy_device
    if max(dlens, default=0) > lz4_device.MAX_DEVICE_BLOCK:
        return dispatch.resolve_host("snappy", "decompress_blocks")(
            chunks, dlens, block_size)
    return snappy_device.decode_blocks(chunks, dlens, block_size,
                                       device=device)
