"""ZSTD codec.

Tiers:
  HOST  — the shared library's zstd encoder and decoder
          (csrc/zstd_encode.cpp, csrc/zstd_decode.cpp): levels 1-22,
          dictionaries.
  TORCH — the device encoder (ops/zstd_device.py) for level 1 and the
          device decoder (ops/zstd_decode_device.py), on the handle's
          device; their serial scans are the hand kernels of
          csrc/zstd_scan.cu and the fetches the compaction kernel.
  MULTI — the level-1 encoder over several devices (parallel/sharded.py).

RAP layout, as the reference's: the RAP frame rides inside a standard zstd
skippable frame (magic 0x184D2A50), so stock zstd tools still decode the
stream; chunk offsets are relative to the RAP frame's start. Each chunk is
an independent zstd frame, and concatenated frames are a valid stream.

The device encoder runs on an explicit opt-in (opt_var >= 2, num_shards >
1, or AOCL_ENABLE_INSTRUCTIONS naming a device tier) at level 1 without a
dictionary; levels >= 2 and dictionaries stay on the host, as in the JAX
package. RAP decode runs on the host unless device decode is enabled
(utils.config.device_decode_enabled). The device tiers' host routes are
the JAX package's, each taken through the dispatch registry so the audit
names it: blocks over 64 KiB, single-shot inputs under 1 KiB, frames the
device decoder does not take, and any dictionary.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence

from ..api.handle import Handle
from ..ops.compact import _no_mark
from ..parallel import container
from ..runtime import native
from ..utils import dispatch
from ..utils.config import (TIER_HOST, TIER_MULTI, TIER_TORCH,
                            device_decode_enabled, get_config)
from .base import Codec, device_opt_in
from .lz4 import multi_shards

_SKIPPABLE_MAGIC = 0x184D2A50
_SKIPPABLE_HEADER_SIZE = 8


class ZstdCodec(Codec):
    name = "zstd"
    version = "1.5.5-tpu"
    min_level, max_level, default_level = 1, 22, 3

    def compress_bound(self, n: int) -> int:
        # standard zstd bound + room for the skippable RAP frame
        bound = n + (n >> 8) + 64
        cfg = get_config()
        return (bound + _SKIPPABLE_HEADER_SIZE
                + native.rap_frame_bound(n, cfg.default_block_size))

    def _block_size(self, handle: Handle) -> int:
        return handle.block_size or get_config().default_block_size

    def _tier_cap(self, handle: Handle, level: int):
        # the device pipeline is the level-1 strategy; quality levels and
        # dictionary compression keep the host tier. At level 1 without a
        # dictionary the cap is the handle's, so num_shards > 1 reaches
        # the multi-device tier (reference: zstd MT inside
        # ZSTD_compress_advanced, zstd_compress.c:5417)
        if level > 1 or handle.dictionary is not None:
            return TIER_HOST
        return handle.max_tier

    def _resolve_cb(self, handle: Handle, level: int):
        cb, tier = dispatch.resolve_with_tier(
            self.name, "compress_blocks", self._tier_cap(handle, level),
            handle.opt_off, calibrated=not device_opt_in(handle))
        if tier == TIER_HOST:
            return lambda blocks, lvl, d: cb(
                blocks, lvl, d, workers=handle.num_shards or None)
        if tier == TIER_MULTI:
            return lambda blocks, lvl, d: cb(
                blocks, lvl, d, handle.device,
                num_shards=multi_shards(handle),
                mem_limit=handle.mem_limit or None)
        # mem_limit caps the input bytes per device batch
        return lambda blocks, lvl, d: cb(blocks, lvl, d, handle.device,
                                         mem_limit=handle.mem_limit or None)

    def compress(self, handle: Handle, data: bytes) -> bytes:
        level = self.clamp_level(handle.level or self.default_level)
        rap = (handle.enable_rap if handle.enable_rap is not None
               else get_config().enable_rap and not container.st_fallback(
                   handle, device_opt_in(handle)))
        bs = self._block_size(handle)
        if rap and len(data) >= 2 * bs:
            return self._compress_rapped(handle, data, level, bs)
        fn, tier = dispatch.resolve_with_tier(
            self.name, "compress", self._tier_cap(handle, level),
            handle.opt_off, calibrated=not device_opt_in(handle))
        if tier == TIER_HOST:
            return fn(data, level, handle.dictionary)
        return fn(data, level, handle.dictionary, handle.device)

    def _compress_rapped(self, handle: Handle, data: bytes, level: int,
                         bs: int) -> bytes:
        blocks = container.split_blocks(data, bs)
        chunks, dlens = self._resolve_cb(handle, level)(blocks, level,
                                                        handle.dictionary)
        n = len(blocks)
        offsets, lens = [], []
        pos = native.rap_frame_len(n)  # relative to the RAP frame's start
        for ch in chunks:
            offsets.append(pos)
            lens.append(len(ch))
            pos += len(ch)
        rap = native.rap_write(n, offsets, lens, dlens)
        skip_hdr = struct.pack("<II", _SKIPPABLE_MAGIC, len(rap))
        return skip_hdr + rap + b"".join(chunks)

    def decompress(self, handle: Handle, data: bytes,
                   expected_size: Optional[int] = None) -> bytes:
        dcap = handle.max_tier if device_decode_enabled() else TIER_HOST
        if len(data) >= _SKIPPABLE_HEADER_SIZE:
            magic, size = struct.unpack_from("<II", data)
            if (magic & 0xFFFFFFF0) == _SKIPPABLE_MAGIC:
                body = data[_SKIPPABLE_HEADER_SIZE:]
                parsed = native.rap_parse(body)
                if parsed is not None:
                    offsets, lens, dlens = parsed
                    chunks = [bytes(body[o:o + l])
                              for o, l in zip(offsets, lens)]
                    db, dtier = dispatch.resolve_with_tier(
                        self.name, "decompress_blocks", dcap,
                        handle.opt_off)
                    dl = [int(d) for d in dlens]
                    if dtier == TIER_HOST:
                        out = db(chunks, dl, handle.dictionary,
                                 workers=handle.num_shards or None)
                    else:
                        out = db(chunks, dl, handle.dictionary,
                                 handle.device)
                    return b"".join(out)
                # unknown skippable frame: stock zstd skips it; so do we
                data = data[_SKIPPABLE_HEADER_SIZE + size:]
        fn, tier = dispatch.resolve_with_tier(self.name, "decompress", dcap,
                                              handle.opt_off)
        if tier == TIER_HOST:
            return fn(data, expected_size, handle.dictionary)
        return fn(data, expected_size, handle.dictionary, handle.device)


# --- host-tier variants -------------------------------------------------------

def train_dictionary(samples: Sequence[bytes], dict_size: int = 16384,
                     level: int = 3, entropy: bool = True) -> bytes:
    """Train a zstd dictionary from sample buffers (host code; the JAX
    package's trainer, byte for byte).

    Content: fastCover-class selection, as the reference's dictBuilder
    (ZDICT_trainFromBuffer): k-byte segments scored by the global frequency
    of their 8-byte dmers, the best segment of each data epoch, with the
    chosen segment's dmer frequencies zeroed so later epochs reward new
    coverage; ascending by score, so the most valuable segments land at the
    dictionary's tail where offsets are shortest. entropy=True (default)
    prepends the ZDICT entropy header (dictID, literal Huffman table, FSE
    tables, repcodes) built from the literals and sequence codes that zstd
    emits on the samples against the content; entropy=False returns the
    raw-content dictionary.
    """
    import numpy as np
    blob = b"".join(samples)
    if entropy:
        content_size = max(256, dict_size - 256)
        content = (blob if len(blob) <= content_size else
                   train_dictionary(samples, content_size, level,
                                    entropy=False))
        with native.ZstdStatsCapture() as st:
            for s in samples[:256]:
                if s:
                    native.zstd_compress(s, level, content)
        dict_id = (native.crc32(content) | 0x80000000) & 0xFFFFFFFF
        header = native.zstd_build_dict_header(
            list(st.lit), dict_id, list(st.ll), list(st.of), list(st.ml))
        return header + content
    if len(blob) <= dict_size:
        return blob
    a = np.frombuffer(blob, dtype=np.uint8)
    D, HB, K = 8, 20, 512
    h = np.zeros(len(a) - D + 1, dtype=np.uint64)
    for k in range(D):
        h = h * np.uint64(1099511628211) + a[k:len(a) - D + 1 + k]
    hb = (h >> np.uint64(64 - HB)).astype(np.int64)
    freq = np.bincount(hb, minlength=1 << HB).astype(np.float64)
    npos = len(hb)
    nseg_budget = max(1, dict_size // K)
    epoch = max(K, npos // nseg_budget)
    chosen = []  # (score, start)
    for e0 in range(0, max(1, npos - K + 1), epoch):
        e1 = min(npos, e0 + epoch + K - 1)
        f = freq[hb[e0:e1]]
        if len(f) < K:
            continue
        cs = np.concatenate([[0.0], np.cumsum(f)])
        w = cs[K:] - cs[:-K]
        i = int(np.argmax(w))
        start = e0 + i
        chosen.append((float(w[i]), start))
        freq[hb[start:start + K]] = 0.0
    chosen.sort()
    parts = [blob[s:s + K] for _, s in chosen]
    return b"".join(parts)[-dict_size:]


@dispatch.register("zstd", "compress", TIER_HOST, "zstd_compress_host")
def _compress_host(data: bytes, level: int, dictionary=None) -> bytes:
    return native.zstd_compress(data, level, dictionary)


@dispatch.register("zstd", "compress_blocks", TIER_HOST,
                   "zstd_compress_blocks_host")
def _compress_blocks_host(blocks: Sequence[bytes], level: int,
                          dictionary=None, workers=None):
    from ..parallel import host_pool
    frames = host_pool.parallel_map(
        lambda b: native.zstd_compress(b, level, dictionary), blocks,
        workers=workers, total_bytes=sum(len(b) for b in blocks))
    return frames, [len(b) for b in blocks]


@dispatch.register("zstd", "decompress", TIER_HOST, "zstd_decompress_host")
def _decompress_host(data: bytes, expected_size=None,
                     dictionary=None) -> bytes:
    # concatenated and skippable frames, checksums, dictionaries
    return native.zstd_decompress(data, expected_size, dictionary)


@dispatch.register("zstd", "decompress_blocks", TIER_HOST,
                   "zstd_decompress_blocks_host")
def _decompress_blocks_host(chunks: Sequence[bytes], dlens: Sequence[int],
                            dictionary=None, workers=None) -> List[bytes]:
    from ..parallel import host_pool
    return host_pool.parallel_map(
        lambda cd: native.zstd_decompress(cd[0], cd[1], dictionary),
        list(zip(chunks, dlens)), workers=workers,
        total_bytes=int(sum(dlens)))


# --- device-tier variants (ops/zstd_device.py, ops/zstd_decode_device.py) ----

def _host_decode(frame: bytes) -> bytes:
    """The device decoder's route for a frame it does not take."""
    return dispatch.resolve_host("zstd", "decompress")(frame)


def _device_frames(blocks: Sequence[bytes], level: int, device,
                   mem_limit=None, mark=_no_mark, bucket=None) -> List[bytes]:
    """Frames of `blocks` from the device encoder on `device`, one batch
    per group of <= mem_limit input bytes. mark is the encoder's stage
    hook, bucket its batch bucket (ops/zstd_device.encode_blocks)."""
    from ..ops import zstd_device
    frames = []
    for g in container.block_groups(blocks, mem_limit):
        frames.extend(zstd_device.encode_blocks(g, level, device=device,
                                                mark=mark, bucket=bucket)[0])
    return frames


@dispatch.register("zstd", "compress_blocks", TIER_TORCH,
                   "zstd_compress_blocks_torch")
def _compress_blocks_torch(blocks: Sequence[bytes], level: int,
                           dictionary=None, device=None, mem_limit=None):
    from ..ops import lz4_device
    if max(len(b) for b in blocks) > lz4_device.MAX_DEVICE_BLOCK:
        # 16-bit position packing
        return dispatch.resolve_host("zstd", "compress_blocks")(
            blocks, level, dictionary)
    return (_device_frames(blocks, level, device, mem_limit),
            [len(b) for b in blocks])


@dispatch.register("zstd", "compress_blocks", TIER_MULTI,
                   "zstd_compress_blocks_multi")
def _compress_blocks_multi(blocks: Sequence[bytes], level: int,
                           dictionary=None, device=None, num_shards=None,
                           mem_limit=None, devices=None):
    """The device encoder sharded over devices (`devices`: an explicit
    shard list), one sharded batch per group of <= mem_limit input bytes;
    a dictionary takes the host tier."""
    from ..ops import lz4_device
    from ..parallel import sharded
    if (max(len(b) for b in blocks) > lz4_device.MAX_DEVICE_BLOCK
            or dictionary is not None):
        return dispatch.resolve_host("zstd", "compress_blocks")(
            blocks, level, dictionary)
    frames = []
    for g in container.block_groups(blocks, mem_limit):
        frames.extend(sharded.sharded_block_call(
            g, lambda p, d, B: _device_frames(p, level, d, bucket=B),
            num_shards, device=device, devices=devices))
    return frames, [len(b) for b in blocks]


@dispatch.register("zstd", "compress", TIER_TORCH, "zstd_compress_torch")
def _compress_torch(data: bytes, level: int, dictionary=None,
                    device=None) -> bytes:
    if len(data) < 1024:  # device dispatch overhead dwarfs tiny inputs
        return dispatch.resolve_host("zstd", "compress")(data, level,
                                                         dictionary)
    blocks = container.split_blocks(data, get_config().default_block_size)
    # concatenated frames are a valid zstd stream
    return b"".join(_compress_blocks_torch(blocks, level, dictionary,
                                           device)[0])


@dispatch.register("zstd", "decompress_blocks", TIER_TORCH,
                   "zstd_decompress_blocks_torch")
def _decompress_blocks_torch(chunks: Sequence[bytes], dlens: Sequence[int],
                             dictionary=None, device=None) -> List[bytes]:
    # a dictionary's window needs host history
    if dictionary is not None:
        return dispatch.resolve_host("zstd", "decompress_blocks")(
            chunks, dlens, dictionary)
    from ..ops import zstd_decode_device
    return zstd_decode_device.decode_chunks(
        list(chunks), [int(d) for d in dlens], device=device,
        host_decode=_host_decode)


@dispatch.register("zstd", "decompress", TIER_TORCH, "zstd_decompress_torch")
def _decompress_torch(data: bytes, expected_size=None, dictionary=None,
                      device=None) -> bytes:
    if dictionary is not None:
        return dispatch.resolve_host("zstd", "decompress")(
            data, expected_size, dictionary)
    from ..ops import zstd_decode_device
    return zstd_decode_device.decode_frames(data, expected_size,
                                            device=device,
                                            host_decode=_host_decode)
