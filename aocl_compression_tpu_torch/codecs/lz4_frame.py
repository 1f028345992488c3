"""LZ4 Frame format (LZ4F) — the interchange container for LZ4 blocks.

From the public LZ4 Frame spec v1.6.1, as the JAX package's:

  magic 0x184D2204 | FLG BD [content size] [dictID] HC | blocks... |
  EndMark 0x00000000 | [content checksum]

  block: u32 LE size (bit 31 = stored/uncompressed) + data + [block xxh32]

Frame blocks are compressed through the lz4 codec's dispatch registry:
the host C++ encoder, or at the device tier the sort-emit encoder and the
compaction kernel (csrc/compact.cu) on the caller's device, one device
call per frame block. Linked-block frames are decoded (history window
carried) but always produced as independent blocks.
"""

from __future__ import annotations

import struct
from typing import Optional

from ..runtime import native
from ..utils import dispatch
from ..utils.config import TIER_HOST
from ..utils.device import resolve_device
from . import lz4 as _lz4  # noqa: F401  (registers the lz4 dispatch tiers)

MAGIC = 0x184D2204
#: block-size id (the BD byte's bits 4-6) -> maximum block size
BLOCK_SIZES = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}


def descriptor_checksum(descriptor: bytes) -> int:
    """The HC byte that follows a frame descriptor."""
    return (native.xxh32(descriptor, 0) >> 8) & 0xFF


def compress_frame(data: bytes, block_size_id: int = 4,
                   content_checksum: bool = True,
                   block_checksum: bool = False,
                   store_content_size: bool = True,
                   accel: int = 1, max_tier: Optional[int] = None,
                   opt_off: bool = False, device=None) -> bytes:
    """Build an LZ4 frame with independent blocks.

    max_tier=None takes the calibrated policy's tier (the host tier while
    the port's calibration table is empty); an explicit device max_tier is
    the caller's opt-in. ``device`` is where a device tier runs: None means
    ``cuda``, which raises where there is none; a host-tier frame needs no
    device and ignores it.
    """
    if block_size_id not in BLOCK_SIZES:
        raise ValueError("block_size_id must be 4..7")
    bs = BLOCK_SIZES[block_size_id]

    flg = (1 << 6) | (1 << 5)  # version 01, independent blocks
    if block_checksum:
        flg |= 1 << 4
    if store_content_size:
        flg |= 1 << 3
    if content_checksum:
        flg |= 1 << 2
    desc = bytes([flg, block_size_id << 4])
    if store_content_size:
        desc += struct.pack("<Q", len(data))

    out = bytearray(struct.pack("<I", MAGIC))
    out += desc
    out.append(descriptor_checksum(desc))

    fn, tier = dispatch.resolve_with_tier("lz4", "compress", max_tier,
                                          opt_off, calibrated=max_tier is None)
    if tier == TIER_HOST:
        comp = fn
    else:
        dev = resolve_device(device)

        def comp(blk, acc):
            return fn(blk, acc, dev)
    for i in range(0, len(data), bs):
        blk = data[i:i + bs]
        c = comp(blk, accel)
        if len(c) >= len(blk):  # incompressible: store raw
            out += struct.pack("<I", len(blk) | 0x80000000)
            payload = blk
        else:
            out += struct.pack("<I", len(c))
            payload = c
        out += payload
        if block_checksum:
            out += struct.pack("<I", native.xxh32(payload, 0))

    out += struct.pack("<I", 0)  # EndMark
    if content_checksum:
        out += struct.pack("<I", native.xxh32(data, 0))
    return bytes(out)


def decompress_frame(data: bytes, max_tier: Optional[int] = None,
                     opt_off: bool = False) -> bytes:
    """Decode an LZ4 frame (independent or linked blocks, checksums
    verified) on the host. max_tier and opt_off are taken, and ignored, as
    the JAX package's decompress_frame takes them: every tier decodes a
    frame on the host."""
    if len(data) < 7 or struct.unpack_from("<I", data)[0] != MAGIC:
        raise ValueError("not an LZ4 frame (bad magic)")
    pos = 4
    flg = data[pos]
    if (flg >> 6) != 1:
        raise ValueError("unsupported LZ4 frame version")
    indep = bool(flg & (1 << 5))
    has_bchk = bool(flg & (1 << 4))
    has_csize = bool(flg & (1 << 3))
    has_cchk = bool(flg & (1 << 2))
    if flg & 1:
        # legal per the spec, but without the dictionary the decode would
        # silently give wrong bytes, so reject loudly
        raise ValueError("lz4 frame: dictionary-linked frames not supported")
    if flg & (1 << 1):
        raise ValueError("lz4 frame: reserved FLG bit set")
    bd = data[pos + 1]
    if bd & 0x8F:
        raise ValueError("lz4 frame: reserved BD bits set")
    bs = BLOCK_SIZES.get((bd >> 4) & 7)
    if bs is None:
        raise ValueError("bad block-size descriptor")
    desc_len = 2 + (8 if has_csize else 0)
    desc = data[pos:pos + desc_len]
    hc = data[pos + desc_len]
    if hc != descriptor_checksum(desc):
        raise ValueError("frame descriptor checksum mismatch")
    content_size = struct.unpack_from("<Q", data, pos + 2)[0] \
        if has_csize else None
    pos += desc_len + 1

    out = bytearray()
    while True:
        if pos + 4 > len(data):
            raise ValueError("truncated frame (missing EndMark)")
        raw = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        if raw == 0:
            break
        stored = bool(raw & 0x80000000)
        n = raw & 0x7FFFFFFF
        if pos + n > len(data):
            raise ValueError("truncated block")
        payload = data[pos:pos + n]
        pos += n
        if has_bchk:
            want = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            if native.xxh32(payload, 0) != want:
                raise ValueError("block checksum mismatch")
        if stored:
            out += payload
        elif indep:
            out += native.lz4_decompress(payload, bs)
        else:
            # linked blocks: decode against the trailing 64K history window
            out += native.lz4_decompress_with_history(
                payload, bs, bytes(out[-65536:]))
    if has_cchk:
        if pos + 4 > len(data):
            raise ValueError("truncated content checksum")
        want = struct.unpack_from("<I", data, pos)[0]
        if native.xxh32(bytes(out), 0) != want:
            raise ValueError("content checksum mismatch")
    if content_size is not None and content_size != len(out):
        raise ValueError("content size mismatch")
    return bytes(out)
