"""zlib, bzip2 and lzma codecs.

Tiers:
  HOST  — own C++ codecs via ctypes: deflate levels 1-9 and inflate
          (csrc/deflate.cpp); bzip2 (csrc/bzip2.cpp: RLE1, BWT, MTF, RLE2,
          multi-table Huffman); lzma (csrc/lzma.cpp: range coder and
          hash-chain match finder, the FORMAT_ALONE layout).
  TORCH — on the handle's device: the deflate encoders
          (ops/deflate_device.py; level 1 as static-Huffman blocks, the
          reference's deflate_quick, level 2 as dynamic-Huffman blocks,
          deflate_medium's; levels 3-9 stay on the host); the device
          inflate (ops/inflate_device.py, with the hand kernel of
          csrc/inflate_scan.cu for its symbol scan) for RAP decode when
          device decode is enabled; the bzip2 block sort as prefix-doubling
          sorts (ops/bwt_device.py), with RLE1, the CRCs and the entropy
          stages on the host; and the lzma match-finder assist
          (ops/lzma_assist.py), whose elected sequences the host range
          coder encodes. bzip2 and lzma decode on the host.
  MULTI — the deflate encoders over several devices (parallel/sharded.py).

The device tiers are used on an explicit opt-in only (device_opt_in);
otherwise dispatch routes by measured speed (utils.calibration), whose
table is empty in the port, so the host tiers run.

The host and fallback routes of the device tiers are the JAX package's,
each taken through the dispatch registry so the audit names it: blocks
over 64 KiB, single-shot zlib inputs under 1 KiB and bzip2 / lzma inputs
under 4 KiB go to the host encoders; a block whose dynamic code fails its
Kraft fixup is re-encoded as a static block on the device
("zlib_compress_static_torch"); RAP chunks that decode to more than 64
KiB go to the host inflate, and chunks the device inflate does not take
(a stored or corrupt first block, multi-block chunks, short decodes) to
"zlib_inflate_chunk_host" one by one.
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
from ..utils.config import (TIER_HOST, TIER_MULTI, TIER_TORCH,
                            device_decode_enabled, get_config)
from .base import Codec, device_opt_in
from .lz4 import multi_shards


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
        elif ctier == TIER_MULTI:
            def compress(blocks):
                return cb(blocks, level, handle.device,
                          num_shards=multi_shards(handle),
                          mem_limit=handle.mem_limit or None)
        else:
            # mem_limit caps the input bytes per device batch
            def compress(blocks):
                return cb(blocks, level, handle.device,
                          mem_limit=handle.mem_limit or None)
        dcap = handle.max_tier if device_decode_enabled() else TIER_HOST
        db, dtier = dispatch.resolve_with_tier("zlib", "decompress_blocks",
                                               dcap, handle.opt_off)
        if dtier == TIER_HOST:
            def decompress(chunks, dlens):
                return db(chunks, dlens, workers=handle.num_shards or None)
        else:
            # mem_limit caps the output bytes per device batch
            def decompress(chunks, dlens):
                return db(chunks, dlens, handle.device,
                          mem_limit=handle.mem_limit or None)
        return container.BlockCodecAdapter(
            compress_blocks=compress, decompress_blocks=decompress,
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


@dispatch.register("zlib", "inflate_chunk", TIER_HOST,
                   "zlib_inflate_chunk_host")
def _zlib_inflate_chunk_host(chunk: bytes, dlen: int) -> bytes:
    """One raw RAP chunk on the host inflate: the device inflate's route
    for a chunk it does not take."""
    return native.inflate(chunk, dlen, raw=True)


# --- device-tier variants (ops/deflate_device.py, ops/inflate_device.py) ----

@dispatch.register("zlib", "compress_static", TIER_TORCH,
                   "zlib_compress_static_torch")
def _compress_static_torch(block: bytes, device) -> bytes:
    """One block as a static-Huffman chunk on `device`: the dynamic path's
    re-encode of a block whose Kraft fixup failed."""
    from ..ops import deflate_device
    return deflate_device.encode_blocks([block], accel=2, device=device)[0]


def _device_chunks(blocks: Sequence[bytes], level: int, device,
                   mem_limit=None, mark=_no_mark, bucket=None) -> List[bytes]:
    """Sync-flushed chunks of `blocks` from the device encoder of `level`
    (1 static, >= 2 dynamic) on `device`, one batch per group of <=
    mem_limit input bytes. mark is the encoder's stage hook, bucket its
    batch bucket."""
    from ..ops import deflate_device
    chunks = []
    for g in container.block_groups(blocks, mem_limit):
        if level >= 2:
            ch, failed = deflate_device.encode_blocks_dyn(
                g, accel=2, device=device, mark=mark, bucket=bucket)
            for i in failed:
                ch[i] = dispatch.resolve("zlib", "compress_static",
                                         TIER_TORCH)(g[i], device)
        else:
            ch = deflate_device.encode_blocks(g, accel=2, device=device,
                                              mark=mark, bucket=bucket)
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


@dispatch.register("zlib", "compress_blocks", TIER_MULTI,
                   "zlib_compress_blocks_multi")
def _zlib_compress_blocks_multi(blocks, level: int, device, num_shards=None,
                                mem_limit=None, devices=None):
    """The deflate encoder of `level` sharded over devices (`devices`: an
    explicit shard list), one sharded batch per group of <= mem_limit input
    bytes."""
    from ..ops import lz4_device
    from ..parallel import sharded
    if max(len(b) for b in blocks) > lz4_device.MAX_DEVICE_BLOCK:
        return dispatch.resolve_host("zlib", "compress_blocks")(blocks, level)
    chunks = []
    for g in container.block_groups(blocks, mem_limit):
        chunks.extend(sharded.sharded_block_call(
            g, lambda p, d, B: _device_chunks(p, level, d, bucket=B),
            num_shards, device=device, devices=devices))
    return chunks, [len(b) for b in blocks]


@dispatch.register("zlib", "compress", TIER_TORCH, "zlib_compress_torch")
def _zlib_compress_torch(data: bytes, level: int, device) -> bytes:
    """Single-shot zlib stream through the device encoder of `level`."""
    if len(data) < 1024:  # device dispatch overhead dwarfs tiny inputs
        return dispatch.resolve_host("zlib", "compress")(data, level)
    bs = min(get_config().default_block_size, 1 << 16)
    chunks = _device_chunks(container.split_blocks(data, bs), level, device)
    return ZLIB_HEADER + b"".join(chunks) + _trailer(data)


def _inflate_host(chunk: bytes, dlen: int) -> bytes:
    return dispatch.resolve_host("zlib", "inflate_chunk")(chunk, dlen)


@dispatch.register("zlib", "decompress_blocks", TIER_TORCH,
                   "zlib_decompress_blocks_torch")
def _zlib_decompress_blocks_torch(chunks, dlens, device, mem_limit=None):
    """Device inflate of RAP chunks (ops/inflate_device.py): the host
    plans each chunk's first block, the device decodes its symbols and
    executes the LZ77 sequences; chunks it does not take decode on the
    host one by one. Opt-in through device decode, as lz4, snappy and zstd
    device decode are."""
    from ..ops import inflate_device, lz4_device
    if max(dlens, default=0) > lz4_device.MAX_DEVICE_BLOCK:
        return dispatch.resolve_host("zlib", "decompress_blocks")(chunks,
                                                                  dlens)
    return inflate_device.decode_chunks(
        list(chunks), [int(d) for d in dlens], device=device,
        host_one=_inflate_host, mem_limit=mem_limit)


# --- bzip2 -----------------------------------------------------------------------

class Bzip2Codec(Codec):
    """bzip2 (reference: BZ2_bzBuffToBuffCompress; level = blockSize100k
    1-9)."""

    name = "bzip2"
    version = "1.0.8-tpu"
    min_level, max_level, default_level = 1, 9, 9

    def compress_bound(self, n: int) -> int:
        # reference bound: n + n/100 + 600 (BZ2_bzBuffToBuffCompress docs)
        return n + (n // 100) + 600

    def compress(self, handle: Handle, data: bytes) -> bytes:
        fn, tier = dispatch.resolve_with_tier(
            "bzip2", "compress", handle.max_tier, handle.opt_off,
            calibrated=not device_opt_in(handle))
        level = self.clamp_level(handle.level or self.default_level)
        if tier != TIER_HOST:
            return fn(data, level, handle.device)
        block = 100_000 * level
        if not handle.opt_off and len(data) > 2 * block:
            # fan-out as CONCATENATED .bz2 streams (the format's own
            # multi-stream rule, the pbzip2 layout): each worker compresses
            # whole blockSize100k chunks, so every block's BWT context and
            # the ratio are the serial encoder's (reference analog: the
            # per-thread partitions of threads/threads.c)
            from ..parallel import host_pool
            chunks = [data[i:i + block] for i in range(0, len(data), block)]
            return b"".join(host_pool.parallel_map(
                lambda ch: fn(ch, level), chunks, workers=handle.num_shards,
                total_bytes=len(data)))
        return fn(data, level)

    def decompress(self, handle: Handle, data: bytes,
                   expected_size: Optional[int] = None) -> bytes:
        fn = dispatch.resolve("bzip2", "decompress", handle.max_tier,
                              handle.opt_off)
        return fn(data, expected_size)


@dispatch.register("bzip2", "compress", TIER_HOST, "bzip2_compress_host")
def _bzip2_compress_host(data: bytes, level: int) -> bytes:
    return native.bz2_compress(data, level)


@dispatch.register("bzip2", "decompress", TIER_HOST, "bzip2_decompress_host")
def _bzip2_decompress_host(data: bytes, expected_size=None) -> bytes:
    return native.bz2_decompress(data, expected_size)


@dispatch.register("bzip2", "compress", TIER_TORCH, "bzip2_compress_torch")
def _bzip2_compress_torch(data: bytes, level: int, device,
                          mark=_no_mark) -> bytes:
    """Device-BWT tier: RLE1, the block split and the CRCs on the host
    (bz2_prepare), the block sort of each block on `device`
    (ops/bwt_device.bwt), MTF, RLE2 and Huffman back on the host
    (bz2_emit). mark(stage) is called at "start", after "prepare", each
    block's "bwt" and "emit"."""
    from ..ops import bwt_device
    if len(data) < 4096:  # device dispatch overhead dwarfs tiny inputs
        return dispatch.resolve_host("bzip2", "compress")(data, level)
    mark("start")
    rle, offs, lens, crcs = native.bz2_prepare(data, level)
    mark("prepare")
    Ls, origs = [], []
    for off, ln in zip(offs, lens):
        if ln == 0:
            continue
        L, I = bwt_device.bwt(rle[off:off + ln].tobytes(), device)
        mark("bwt")
        Ls.append(L)
        origs.append(I)
    keep = lens > 0
    out = native.bz2_emit(level, b"".join(Ls), lens[keep], origs, crcs[keep])
    mark("emit")
    return out


# --- lzma ------------------------------------------------------------------------

class LzmaCodec(Codec):
    """lzma, the FORMAT_ALONE stream (reference adapter: the 5-byte props
    header spliced before the stream, api/codec.cpp:206-243)."""

    name = "lzma"
    version = "22.01-tpu"
    min_level, max_level, default_level = 0, 9, 6

    def compress_bound(self, n: int) -> int:
        # reference: inSize + inSize/3 + 128 style slack + 13 B header
        return n + (n // 3) + 128 + 13

    def compress(self, handle: Handle, data: bytes) -> bytes:
        fn, tier = dispatch.resolve_with_tier(
            "lzma", "compress", handle.max_tier, handle.opt_off,
            calibrated=not device_opt_in(handle))
        level = self.clamp_level(handle.level or self.default_level)
        if tier == TIER_HOST:
            return fn(data, level)
        # mem_limit caps the input bytes per device batch
        return fn(data, level, handle.device,
                  mem_limit=handle.mem_limit or None)

    def decompress(self, handle: Handle, data: bytes,
                   expected_size: Optional[int] = None) -> bytes:
        fn = dispatch.resolve("lzma", "decompress", handle.max_tier,
                              handle.opt_off)
        return fn(data, expected_size)


@dispatch.register("lzma", "compress", TIER_HOST, "lzma_compress_host")
def _lzma_compress_host(data: bytes, level: int) -> bytes:
    return native.lzma_compress(data, level)


@dispatch.register("lzma", "decompress", TIER_HOST, "lzma_decompress_host")
def _lzma_decompress_host(data: bytes, expected_size=None) -> bytes:
    return native.lzma_decompress(data, expected_size)


@dispatch.register("lzma", "compress", TIER_TORCH, "lzma_compress_torch")
def _lzma_compress_torch(data: bytes, level: int, device, mem_limit=None,
                         mark=_no_mark) -> bytes:
    """Device match-finder assist (ops/lzma_assist.py): the device elects
    (pos, len, dist) sequences per 64 KiB block, the LzFind.c stage, and
    the host range coder encodes candidate-driven. Matches cannot cross
    64 KiB blocks, so the ratio trails the host tier's."""
    from ..ops import lzma_assist
    if len(data) < 4096:  # device dispatch overhead dwarfs tiny inputs
        return dispatch.resolve_host("lzma", "compress")(data, level)
    return lzma_assist.compress(data, level, device=device,
                                mem_limit=mem_limit, mark=mark)
