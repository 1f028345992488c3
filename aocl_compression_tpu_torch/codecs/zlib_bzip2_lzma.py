"""zlib codec (bzip2 and lzma are not ported yet).

Tiers:
  HOST  — own C++ deflate levels 1-9 and inflate (csrc/deflate.cpp) via
          ctypes.
  TORCH — the device deflate encoders (ops/deflate_device.py) on the
          handle's device: level 1 as static-Huffman blocks (the
          reference's deflate_quick), level 2 as dynamic-Huffman blocks
          (deflate_medium's dynamic blocks); levels 3-9 stay on the host.
Decode runs on the host inflate. The JAX package's device inflate
(ops/inflate_device.py) is not ported yet: with AOCL_DEVICE_DECODE=1 the
port's zlib decode still goes to the host tier.

The device tier is used on an explicit opt-in only (device_opt_in);
otherwise dispatch routes by measured speed (utils.calibration), whose
table is empty in the port, so the host tier runs.

The host and fallback routes of the device tier are the JAX package's,
each taken through the dispatch registry so the audit names it: blocks
over 64 KiB and single-shot inputs under 1 KiB go to the host deflate,
and a block whose dynamic code fails its Kraft fixup is re-encoded as a
static block on the device ("zlib_compress_static_torch").
"""

from __future__ import annotations

import struct
import zlib  # adler32 only
from typing import List, Optional, Sequence

from ..api.handle import Handle
from ..ops.compact import _no_mark
from ..ops.deflate_device import FINAL_BLOCK, ZLIB_HEADER
from ..parallel import container
from ..runtime import native
from ..utils import dispatch
from ..utils.config import (TIER_HOST, TIER_TORCH, device_decode_enabled,
                            get_config)
from .base import Codec, device_opt_in


def _trailer(data: bytes) -> bytes:
    """The stream's end: the empty final static block and the adler32."""
    return FINAL_BLOCK + struct.pack(">I", zlib.adler32(data) & 0xFFFFFFFF)


class ZlibCodec(Codec):
    """zlib with RAP block parallelism (reference: RAP paths inside
    compress2/uncompress, algos/zlib/compress.c:211-340, uncompr.c:180-198).

    Stream layout under RAP: [RAP frame][2B zlib header][sync-flushed raw
    deflate chunk]xN[empty final block][adler32]. Skipping the RAP frame
    yields a bit-valid zlib stream for stock decoders.
    """

    name = "zlib"
    version = "1.3-tpu"
    min_level, max_level, default_level = 1, 9, 6

    def compress_bound(self, n: int) -> int:
        cfg = get_config()
        return (n + (n >> 8) + 64
                + native.rap_frame_bound(n, cfg.default_block_size))

    def _block_size(self, handle: Handle, level: Optional[int] = None) -> int:
        if handle.block_size:
            return handle.block_size
        cfg = get_config()
        lvl = level if level is not None else \
            self.clamp_level(handle.level or self.default_level)
        if lvl <= 2 and device_opt_in(handle) and (
                handle.max_tier is None or handle.max_tier >= TIER_TORCH):
            # device tiers: blocks within the 16-bit limit
            return min(cfg.default_block_size, 1 << 16)
        # reference partition rule: chunk = search window x WINDOW_FACTOR
        # (threads/threads.c:57; 32K deflate window x 4) — smaller chunks
        # truncate back-references and cost ratio on the host tiers
        return max(cfg.default_block_size, 4 * 32768)

    def _adapter(self, handle: Handle,
                 level: int) -> container.BlockCodecAdapter:
        # device tier for the quick (level 1, static) and medium (level 2,
        # dynamic) strategies; higher levels keep host ratio semantics
        max_tier = handle.max_tier if level <= 2 else TIER_HOST
        cb, ctier = dispatch.resolve_with_tier(
            "zlib", "compress_blocks", max_tier, handle.opt_off,
            calibrated=not device_opt_in(handle))
        if ctier == TIER_HOST:
            def compress(blocks):
                return cb(blocks, level, workers=handle.num_shards or None)
        else:
            # mem_limit caps the input bytes per device batch
            def compress(blocks):
                return cb(blocks, level, handle.device,
                          mem_limit=handle.mem_limit or None)
        dcap = handle.max_tier if device_decode_enabled() else TIER_HOST
        db = dispatch.resolve("zlib", "decompress_blocks", dcap,
                              handle.opt_off)
        return container.BlockCodecAdapter(
            compress_blocks=compress,
            decompress_blocks=lambda chunks, dlens: db(
                chunks, dlens, workers=handle.num_shards or None),
            preamble=lambda total: ZLIB_HEADER)

    def compress(self, handle: Handle, data: bytes) -> bytes:
        level = self.clamp_level(handle.level or self.default_level)
        rap = (handle.enable_rap if handle.enable_rap is not None
               else get_config().enable_rap and not container.st_fallback(
                   handle, device_opt_in(handle) and level <= 2))
        if rap:
            out = container.compress_rapped(
                data, self._block_size(handle, level),
                self._adapter(handle, level))
            if out is not None:
                return out + _trailer(data)
        fn, tier = dispatch.resolve_with_tier(
            "zlib", "compress", handle.max_tier if level <= 2 else TIER_HOST,
            handle.opt_off, calibrated=not device_opt_in(handle))
        if tier == TIER_HOST:
            return fn(data, level)
        return fn(data, level, handle.device)

    def decompress(self, handle: Handle, data: bytes,
                   expected_size: Optional[int] = None) -> bytes:
        out = container.decompress_rapped(data, self._adapter(handle, 1))
        if out is not None:
            # verify the adler32 trailer appended at compress time (stock
            # zlib would; the RAP path must not silently pass corruption)
            if len(data) >= 4:
                want = struct.unpack(">I", data[-4:])[0]
                if zlib.adler32(out) & 0xFFFFFFFF != want:
                    raise ValueError("zlib: adler32 mismatch on RAP stream")
            return out
        fn = dispatch.resolve("zlib", "decompress", handle.max_tier,
                              handle.opt_off)
        return fn(data, expected_size)


# --- host-tier variants -------------------------------------------------------

@dispatch.register("zlib", "compress", TIER_HOST, "zlib_compress_host")
def _zlib_compress_host(data: bytes, level: int) -> bytes:
    return native.deflate(data, level, native.DEFLATE_ZLIB)


@dispatch.register("zlib", "decompress", TIER_HOST, "zlib_decompress_host")
def _zlib_decompress_host(data: bytes, expected_size=None) -> bytes:
    return native.inflate(data, expected_size)


@dispatch.register("zlib", "compress_blocks", TIER_HOST,
                   "zlib_compress_blocks_host")
def _zlib_compress_blocks_host(blocks, level: int, workers=None):
    """Per-block sync-flushed raw deflate (concatenatable chunks), fanned
    out over the host pool (reference MT compress2,
    algos/zlib/compress.c:211-340)."""
    from ..parallel import host_pool
    frags = host_pool.parallel_map(
        lambda b: native.deflate(b, level, native.DEFLATE_SYNC_CHUNK),
        blocks, workers=workers, total_bytes=sum(len(b) for b in blocks))
    return frags, [len(b) for b in blocks]


@dispatch.register("zlib", "decompress_blocks", TIER_HOST,
                   "zlib_decompress_blocks_host")
def _zlib_decompress_blocks_host(chunks, dlens, workers=None):
    # parallel RAP fan-out (reference MT uncompress, uncompr.c:180-198)
    from ..parallel import host_pool
    return host_pool.parallel_map(
        lambda cd: native.inflate(cd[0], cd[1], raw=True),
        list(zip(chunks, dlens)), workers=workers,
        total_bytes=int(sum(dlens)))


# --- device-tier variants (ops/deflate_device.py) -----------------------------

@dispatch.register("zlib", "compress_static", TIER_TORCH,
                   "zlib_compress_static_torch")
def _compress_static_torch(block: bytes, device) -> bytes:
    """One block as a static-Huffman chunk on `device`: the dynamic path's
    re-encode of a block whose Kraft fixup failed."""
    from ..ops import deflate_device
    return deflate_device.encode_blocks([block], accel=2, device=device)[0]


def _device_chunks(blocks: Sequence[bytes], level: int, device,
                   mem_limit=None, mark=_no_mark) -> List[bytes]:
    """Sync-flushed chunks of `blocks` from the device encoder of `level`
    (1 static, >= 2 dynamic) on `device`, one batch per group of <=
    mem_limit input bytes. mark is the encoder's stage hook."""
    from ..ops import deflate_device
    chunks = []
    for g in container.block_groups(blocks, mem_limit):
        if level >= 2:
            ch, failed = deflate_device.encode_blocks_dyn(
                g, accel=2, device=device, mark=mark)
            for i in failed:
                ch[i] = dispatch.resolve("zlib", "compress_static",
                                         TIER_TORCH)(g[i], device)
        else:
            ch = deflate_device.encode_blocks(g, accel=2, device=device,
                                              mark=mark)
        chunks.extend(ch)
    return chunks


@dispatch.register("zlib", "compress_blocks", TIER_TORCH,
                   "zlib_compress_blocks_torch")
def _zlib_compress_blocks_torch(blocks, level: int, device, mem_limit=None):
    from ..ops import lz4_device
    if max(len(b) for b in blocks) > lz4_device.MAX_DEVICE_BLOCK:
        # 16-bit position packing
        return dispatch.resolve_host("zlib", "compress_blocks")(blocks, level)
    return (_device_chunks(blocks, level, device, mem_limit),
            [len(b) for b in blocks])


@dispatch.register("zlib", "compress", TIER_TORCH, "zlib_compress_torch")
def _zlib_compress_torch(data: bytes, level: int, device) -> bytes:
    """Single-shot zlib stream through the device encoder of `level`."""
    if len(data) < 1024:  # device dispatch overhead dwarfs tiny inputs
        return dispatch.resolve_host("zlib", "compress")(data, level)
    bs = min(get_config().default_block_size, 1 << 16)
    chunks = _device_chunks(container.split_blocks(data, bs), level, device)
    return ZLIB_HEADER + b"".join(chunks) + _trailer(data)
