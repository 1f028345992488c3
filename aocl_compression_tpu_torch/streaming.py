"""Bounded-memory streaming compression and decompression (host only).

The unified API is one-shot; this module is the streaming surface, as in
the JAX package and byte for byte: input is taken in writes of any size,
compressed block by block and emitted incrementally as a SERIAL stream in
each codec's standard concatenatable layout, the bytes a stock decoder
(and the one-shot decompress) accepts:

  zlib  — [2B header][sync-flushed raw chunk]xN[final block][adler32]
          (the RAP path's layout after skip_rap_frame)
  gzip  — one RFC 1952 member over the same raw-deflate chunking (header,
          CRC32 + ISIZE trailer); decode accepts concatenated members
  zstd  — concatenated standard frames (RFC 8878 permits concatenation)
  bzip2 — concatenated .bz2 streams (the format's multi-stream rule)
  lz4   — one LZ4 frame with linked blocks and a content checksum

DecompressStream decodes every codec incrementally with bounded memory:
zstd frame by frame (the library reports each frame's consumed size),
zlib and gzip through the library's resumable inflate context, bzip2 a
block at a time, lz4 through the frame's state machine with a 64 KiB
history. No path buffers the whole stream.

Both classes run the shared C++ host library only: the JAX package's
streams take no device tier, so these take no device and have nothing to
fall back from.
"""

from __future__ import annotations

import struct

from .codecs.lz4_frame import BLOCK_SIZES as _LZ4F_BLOCK_SIZES
from .codecs.lz4_frame import MAGIC as _LZ4F_MAGIC
from .codecs.lz4_frame import descriptor_checksum
from .runtime import native

_ZLIB_HEADER = b"\x78\x01"
_ZLIB_FINAL = b"\x03\x00"

_STREAM_CODECS = ("zlib", "gzip", "zstd", "bzip2", "lz4")



class CompressStream:
    """Incremental compressor with bounded memory (~2 x block_size).

    >>> cs = CompressStream("zstd", level=3)
    >>> out = cs.write(part1) + cs.write(part2) + cs.finish()
    """

    def __init__(self, codec: str, level: int = 0,
                 block_size: int = 1 << 20):
        if codec not in _STREAM_CODECS:
            raise ValueError(
                f"streaming supports {_STREAM_CODECS}, not {codec!r} "
                "(snappy's block format has no stream preamble)")
        self.codec = codec
        self.level = level
        self.block_size = block_size
        self._buf = bytearray()
        self._started = False
        self._finished = False
        self._adler = 1
        self._crc = 0
        self._total_in = 0
        if codec == "lz4":
            # LZ4F frame with LINKED blocks: each block's matches may
            # reference the previous 64 KiB (the reference's
            # LZ4F_compressUpdate path, algos/lz4/lz4frame.c); decoders:
            # upstream lz4, codecs.lz4_frame.decompress_frame, and
            # DecompressStream("lz4")
            for bsid, bsz in sorted(_LZ4F_BLOCK_SIZES.items()):
                if block_size <= bsz:
                    self._lz4_bsid = bsid
                    break
            else:
                self._lz4_bsid = 7
            self.block_size = min(block_size,
                                  _LZ4F_BLOCK_SIZES[self._lz4_bsid])
            self._lz4_hist = b""
            self._lz4_xxh = native.XXH32Stream()

    def _compress_block(self, block: bytes) -> bytes:
        if self.codec == "zlib":
            self._adler = native.adler32(block, self._adler)
            return native.deflate(block, self.level or 6,
                                  native.DEFLATE_SYNC_CHUNK)
        if self.codec == "gzip":
            self._crc = native.crc32(block, self._crc)
            return native.deflate(block, self.level or 6,
                                  native.DEFLATE_SYNC_CHUNK)
        if self.codec == "zstd":
            return native.zstd_compress(block, self.level or 3)
        if self.codec == "lz4":
            self._lz4_xxh.update(block)
            c = native.lz4_compress_continue(block, self._lz4_hist,
                                             max(1, self.level or 1))
            self._lz4_hist = (self._lz4_hist + block)[-65536:]
            if len(c) >= len(block):  # incompressible: stored block
                return struct.pack("<I", len(block) | 0x80000000) + block
            return struct.pack("<I", len(c)) + c
        return native.bz2_compress(block, self.level or 9)

    def write(self, data: bytes) -> bytes:
        if self._finished:
            raise ValueError("stream already finished")
        self._buf += data
        self._total_in += len(data)
        out = bytearray()
        if not self._started:
            if self.codec == "zlib":
                out += _ZLIB_HEADER
            elif self.codec == "gzip":
                out += native.GZIP_HEADER
            elif self.codec == "lz4":
                out += self._lz4_header()
            self._started = True
        while len(self._buf) >= self.block_size:
            block = bytes(self._buf[:self.block_size])
            del self._buf[:self.block_size]
            out += self._compress_block(block)
        return bytes(out)

    def finish(self) -> bytes:
        if self._finished:
            raise ValueError("stream already finished")
        self._finished = True
        out = bytearray()
        if not self._started:
            if self.codec == "zlib":
                out += _ZLIB_HEADER
            elif self.codec == "gzip":
                out += native.GZIP_HEADER
            elif self.codec == "lz4":
                out += self._lz4_header()
            self._started = True
        if self._buf or (self._total_in == 0 and self.codec != "lz4"):
            out += self._compress_block(bytes(self._buf))
            self._buf.clear()
        if self.codec == "zlib":
            out += _ZLIB_FINAL
            out += struct.pack(">I", self._adler & 0xFFFFFFFF)
        elif self.codec == "gzip":
            out += _ZLIB_FINAL  # final empty raw block
            out += struct.pack("<II", self._crc & 0xFFFFFFFF,
                               self._total_in & 0xFFFFFFFF)
        elif self.codec == "lz4":
            out += struct.pack("<I", 0)  # EndMark
            out += struct.pack("<I", self._lz4_xxh.digest())
        return bytes(out)

    def _lz4_header(self) -> bytes:
        flg = (1 << 6) | (1 << 2)  # version 01, linked blocks, C.Checksum
        desc = bytes([flg, self._lz4_bsid << 4])
        return (struct.pack("<I", _LZ4F_MAGIC) + desc
                + bytes([descriptor_checksum(desc)]))


class DecompressStream:
    """Incremental decompressor — all codecs decode as input arrives.

    zstd: frame-by-frame (the C runtime reports consumed sizes);
    zlib: resumable C inflate context (O(window) memory);
    bzip2: block-at-a-time C context (O(blockSize) memory).
    """

    def __init__(self, codec: str):
        if codec not in _STREAM_CODECS:
            raise ValueError(f"streaming supports {_STREAM_CODECS}")
        self.codec = codec
        self._buf = bytearray()  # zstd/gzip: holdback buffer
        self._finished = False
        self._ctx = None
        if codec == "zlib":
            self._ctx = native.InflateStream(raw=False)
        elif codec == "bzip2":
            self._ctx = native.Bz2DecodeStream()
        elif codec == "lz4":
            # LZ4F frame state machine: header -> blocks (linked or
            # independent; 64 KiB history carried) -> trailer; multiple
            # concatenated frames supported like upstream lz4
            self._lz4_state = "header"
            self._lz4_hist = b""
            self._lz4_xxh = None
            self._lz4_hdr = None
        elif codec == "gzip":
            # member state machine: header -> body (raw inflate ctx with a
            # fed-but-unconsumed mirror so the trailer can be located) ->
            # trailer -> header (concatenated members)
            self._gz_state = "header"
            self._gz_inf = None
            self._gz_mirror = bytearray()
            self._gz_crc = 0
            self._gz_isize = 0
            self._gz_members = 0

    def pending_input(self) -> int:
        """Compressed bytes currently buffered (bounded-memory hook)."""
        if self._ctx is not None:
            return self._ctx.pending_input()
        return len(self._buf)

    def write(self, data: bytes) -> bytes:
        if self._finished:
            raise ValueError("stream already finished")
        if self._ctx is not None:
            return self._ctx.decode(data)
        if self.codec == "gzip":
            self._buf += data
            return self._gz_pump(final=False)
        if self.codec == "lz4":
            self._buf += data
            return self._lz4_pump()
        self._buf += data
        out = bytearray()
        while True:
            res = native.zstd_decompress_frame(bytes(self._buf))
            if res is None:
                break  # incomplete frame: wait for more input
            decoded, consumed = res
            out += decoded
            del self._buf[:consumed]
            if not self._buf:
                break
        return bytes(out)

    def _lz4_pump(self) -> bytes:
        out = bytearray()
        while True:
            if self._lz4_state == "header":
                if len(self._buf) < 7:
                    break
                magic = struct.unpack_from("<I", self._buf)[0]
                if magic != _LZ4F_MAGIC:
                    if (magic & 0xFFFFFFF0) == 0x184D2A50:  # skippable
                        if len(self._buf) < 8:
                            break
                        n = struct.unpack_from("<I", self._buf, 4)[0]
                        if len(self._buf) < 8 + n:
                            break
                        del self._buf[:8 + n]
                        continue
                    raise ValueError("not an LZ4 frame (bad magic)")
                flg = self._buf[4]
                if (flg >> 6) != 1:
                    raise ValueError("unsupported LZ4 frame version")
                has_csize = bool(flg & (1 << 3))
                dlen = 2 + (8 if has_csize else 0) + (4 if flg & 1 else 0)
                if len(self._buf) < 4 + dlen + 1:
                    break
                desc = bytes(self._buf[4:4 + dlen])
                if self._buf[4 + dlen] != descriptor_checksum(desc):
                    raise ValueError("frame descriptor checksum mismatch")
                if flg & 1:
                    raise ValueError(
                        "lz4 frame: dictionary-linked frames not supported")
                bs = _LZ4F_BLOCK_SIZES.get((self._buf[5] >> 4) & 7)
                if bs is None:
                    raise ValueError("bad block-size descriptor")
                self._lz4_hdr = {
                    "indep": bool(flg & (1 << 5)),
                    "bchk": bool(flg & (1 << 4)),
                    "cchk": bool(flg & (1 << 2)),
                    "bs": bs,
                }
                self._lz4_hist = b""
                self._lz4_xxh = native.XXH32Stream()
                del self._buf[:4 + dlen + 1]
                self._lz4_state = "blocks"
            elif self._lz4_state == "blocks":
                if len(self._buf) < 4:
                    break
                raw = struct.unpack_from("<I", self._buf)[0]
                if raw == 0:  # EndMark
                    del self._buf[:4]
                    self._lz4_state = "trailer"
                    continue
                stored = bool(raw & 0x80000000)
                n = raw & 0x7FFFFFFF
                need = 4 + n + (4 if self._lz4_hdr["bchk"] else 0)
                if len(self._buf) < need:
                    break
                payload = bytes(self._buf[4:4 + n])
                if self._lz4_hdr["bchk"]:
                    want = struct.unpack_from("<I", self._buf, 4 + n)[0]
                    if native.xxh32(payload, 0) != want:
                        raise ValueError("block checksum mismatch")
                del self._buf[:need]
                if stored:
                    blk = payload
                elif self._lz4_hdr["indep"]:
                    blk = native.lz4_decompress(payload, self._lz4_hdr["bs"])
                else:
                    blk = native.lz4_decompress_with_history(
                        payload, self._lz4_hdr["bs"], self._lz4_hist)
                self._lz4_hist = (self._lz4_hist + blk)[-65536:]
                self._lz4_xxh.update(blk)
                out += blk
            else:  # trailer
                if self._lz4_hdr["cchk"]:
                    if len(self._buf) < 4:
                        break
                    want = struct.unpack_from("<I", self._buf)[0]
                    if self._lz4_xxh.digest() != want:
                        raise ValueError("content checksum mismatch")
                    del self._buf[:4]
                self._lz4_state = "header"  # concatenated frames
                if not self._buf:
                    break
        return bytes(out)

    def _gz_pump(self, final: bool) -> bytes:
        out = bytearray()
        while True:
            if self._gz_state == "header":
                hdr = self._gz_header_len(bytes(self._buf))
                if hdr is None:
                    if final and self._buf:
                        raise ValueError("gzip: truncated header")
                    break
                del self._buf[:hdr]
                self._gz_inf = native.InflateStream(raw=True)
                self._gz_mirror = bytearray()
                self._gz_crc = 0
                self._gz_isize = 0
                self._gz_state = "body"
            elif self._gz_state == "body":
                chunk = bytes(self._buf)
                self._buf.clear()
                self._gz_mirror += chunk
                part = self._gz_inf.decode(chunk, final=final)
                if part:
                    out += part
                    self._gz_crc = native.crc32(part, self._gz_crc)
                    self._gz_isize += len(part)
                consumed = len(self._gz_mirror) \
                    - self._gz_inf.tail_bytes()
                del self._gz_mirror[:consumed]
                if self._gz_inf.done:
                    self._buf[:0] = self._gz_mirror
                    self._gz_mirror = bytearray()
                    self._gz_inf = None
                    self._gz_state = "trailer"
                else:
                    if final:
                        raise ValueError("gzip: truncated member body")
                    break
            else:  # trailer
                if len(self._buf) < 8:
                    if final:
                        raise ValueError("gzip: truncated trailer")
                    break
                want_crc, want_isize = struct.unpack_from(
                    "<II", bytes(self._buf[:8]))
                del self._buf[:8]
                if want_crc != (self._gz_crc & 0xFFFFFFFF) \
                        or want_isize != (self._gz_isize & 0xFFFFFFFF):
                    raise ValueError("gzip: CRC/ISIZE mismatch")
                self._gz_members += 1
                self._gz_state = "header"
        return bytes(out)

    @staticmethod
    def _gz_header_len(data: bytes):
        """Parsed member-header length, or None if more input is needed."""
        if len(data) < 10:
            return None
        if data[:2] != b"\x1f\x8b" or data[2] != 8:
            raise ValueError("gzip: bad header")
        flg = data[3]
        p = 10
        if flg & 4:  # FEXTRA
            if len(data) < p + 2:
                return None
            xlen = struct.unpack_from("<H", data, p)[0]
            p += 2 + xlen
        if flg & 8:  # FNAME
            q = data.find(b"\x00", p)
            if q < 0:
                return None
            p = q + 1
        if flg & 16:  # FCOMMENT
            q = data.find(b"\x00", p)
            if q < 0:
                return None
            p = q + 1
        if flg & 2:  # FHCRC
            p += 2
        return p if len(data) >= p else None

    def finish(self) -> bytes:
        if self._finished:
            raise ValueError("stream already finished")
        self._finished = True
        if self._ctx is not None:
            return self._ctx.decode(b"", final=True)
        if self.codec == "gzip":
            out = self._gz_pump(final=True)
            if self._gz_state != "header" or self._buf:
                raise ValueError("gzip: incomplete trailing member")
            return out
        if not self._buf:
            return b""
        data = bytes(self._buf)
        self._buf.clear()
        # leftover bytes must form complete frame(s)
        out = bytearray()
        while data:
            res = native.zstd_decompress_frame(data)
            if res is None:
                raise ValueError("zstd stream truncated mid-frame")
            decoded, consumed = res
            out += decoded
            data = data[consumed:]
        return bytes(out)
