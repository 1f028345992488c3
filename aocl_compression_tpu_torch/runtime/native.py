"""ctypes bindings to the shared host runtime (csrc/libaocl_tpu_host.so).

The port binds the same C++ library as the JAX package, restricted to the
symbols its codecs and host surface use: the LZ4 and LZ4HC block codecs
(with the linked-block encoder and the history-window decoder of LZ4
frames), raw snappy, the deflate encoder, inflate, the inflate planner
(the device inflate's header cracking) and the resumable inflate stream,
gzip members, CRC-32, Adler-32, XXH32 (one-shot and streaming) and XXH64,
the bzip2 codec, its device-BWT stages (prepare, emit) and its resumable
decode stream, the LZMA codec, its candidate-driven encoder and the
stateful LZMA2 chunk decoder (.xz), the zstd encoder, decoder,
frame-at-a-time decoder, frame planner (the device decoder's header
cracking) and the dictionary builder's statistics capture and entropy
header, and the RAP container writer/parser. Every signature is the JAX
binding's. The library is built with ``make -C csrc`` on first use when it
is missing or older than its sources.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
from typing import Optional

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_LIBPATH = os.path.join(_CSRC, "libaocl_tpu_host.so")

_lib = None
_lock = threading.Lock()

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i64 = ctypes.c_int64
_i32 = ctypes.c_int32

_SIGNATURES = [
    ("atpu_lz4_compress_bound", _i64, [_i64]),
    ("atpu_lz4_compress", _i64, [_u8p, _i64, _u8p, _i64, _i32]),
    ("atpu_lz4_compress_tail", _i64,
     [_u8p, _i64, _u8p, _i64, _i32, ctypes.POINTER(_i64)]),
    ("atpu_lz4hc_compress", _i64, [_u8p, _i64, _u8p, _i64, _i32]),
    ("atpu_lz4hc_compress_tail", _i64,
     [_u8p, _i64, _u8p, _i64, _i32, ctypes.POINTER(_i64)]),
    ("atpu_lz4_decompress", _i64, [_u8p, _i64, _u8p, _i64]),
    ("atpu_lz4_decompressed_size", _i64, [_u8p, _i64]),
    ("atpu_snappy_max_compressed_length", _i64, [_i64]),
    ("atpu_snappy_compress", _i64, [_u8p, _i64, _u8p, _i64]),
    ("atpu_snappy_uncompressed_length", _i64, [_u8p, _i64]),
    ("atpu_snappy_uncompress", _i64, [_u8p, _i64, _u8p, _i64]),
    ("atpu_deflate", _i64,
     [_u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t, _i32, _i32]),
    ("atpu_inflate", _i64,
     [_u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t, _i32]),
    ("atpu_deflate_bound", _i64, [_i64]),
    ("atpu_inflate_plan", _i64,
     [_u8p, ctypes.c_size_t, _u8p, _u8p, ctypes.POINTER(_i64)]),
    ("atpu_bz2_compress", _i64,
     [_u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t, _i32]),
    ("atpu_bz2_decompress", _i64,
     [_u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t]),
    ("atpu_bz2_prepare", _i64,
     [_u8p, ctypes.c_size_t, _i32, _u8p, ctypes.c_size_t,
      ctypes.POINTER(_i64), ctypes.POINTER(_i64), _u32p, _i32]),
    ("atpu_bz2_emit", _i64,
     [_i32, _i32, _u8p, ctypes.POINTER(_i64), ctypes.POINTER(_i64), _u32p,
      _u8p, ctypes.c_size_t]),
    ("atpu_lzma_compress", _i64,
     [_u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t, _i32]),
    ("atpu_lzma_decompress", _i64,
     [_u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t]),
    ("atpu_lzma_unpacked_size", _i64, [_u8p, ctypes.c_size_t]),
    ("atpu_lzma_compress_cand", _i64,
     [_u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t, _i32,
      ctypes.POINTER(_i64), ctypes.POINTER(_i32), ctypes.POINTER(_i32),
      _i64]),
    ("atpu_rap_frame_len", _i64, [_i32]),
    ("atpu_rap_write", _i64, [_u8p, _i64, _i32, _u32p, _u32p, _u32p]),
    ("atpu_rap_parse", _i64, [_u8p, _i64, _u32p, _u32p, _u32p, _i32]),
    ("atpu_rap_skip", _i64, [_u8p, _i64]),
    ("atpu_rap_frame_bound", _i64, [_i64, _i64]),
    ("atpu_zstd_decompress", _i64,
     [_u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t]),
    ("atpu_zstd_frame_content_size", _i64, [_u8p, ctypes.c_size_t]),
    ("atpu_zstd_frame_compressed_size", _i64, [_u8p, ctypes.c_size_t]),
    ("atpu_zstd_compress_ex", _i64,
     [_u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t, _i32, _u8p,
      ctypes.c_size_t, _i32]),
    ("atpu_zstd_compress_bound", _i64, [_i64]),
    ("atpu_zstd_frame_plan", _i64,
     [_u8p, ctypes.c_size_t, ctypes.POINTER(_i32),
      ctypes.POINTER(ctypes.c_uint16), _u32p, _i64, ctypes.POINTER(_i64)]),
    # the host surface: LZ4 frames, streams, gzip, .xz, dictionaries
    ("atpu_xxh32", ctypes.c_uint32, [_u8p, _i64, ctypes.c_uint32]),
    ("atpu_xxh32_init", None, [ctypes.c_void_p, ctypes.c_uint32]),
    ("atpu_xxh32_update", None, [ctypes.c_void_p, _u8p, _i64]),
    ("atpu_xxh32_digest", ctypes.c_uint32, [ctypes.c_void_p]),
    ("atpu_xxh64", ctypes.c_uint64, [_u8p, ctypes.c_size_t, ctypes.c_uint64]),
    ("atpu_lz4_compress_continue", _i64, [_u8p, _i64, _u8p, _i64, _i32, _i64]),
    ("atpu_lz4_decompress_dict", _i64, [_u8p, _i64, _u8p, _i64, _u8p, _i64]),
    ("atpu_zstd_decompress_frame", _i64,
     [_u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t,
      ctypes.POINTER(ctypes.c_size_t)]),
    ("atpu_adler32", ctypes.c_uint32,
     [_u8p, ctypes.c_size_t, ctypes.c_uint32]),
    ("atpu_crc32", ctypes.c_uint32, [_u8p, ctypes.c_size_t, ctypes.c_uint32]),
    ("atpu_inflate_consumed", _i64,
     [_u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t,
      ctypes.POINTER(ctypes.c_size_t)]),
    ("atpu_lzma2_ctx_new", ctypes.c_void_p, []),
    ("atpu_lzma2_ctx_free", None, [ctypes.c_void_p]),
    ("atpu_lzma2_decode_chunk", _i64,
     [ctypes.c_void_p, _u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t,
      ctypes.c_size_t, ctypes.c_uint64, _i32, _i32, ctypes.c_size_t]),
    ("atpu_lzma2_mark_uncompressed", None, [ctypes.c_void_p]),
    ("atpu_zstd_build_dict_header", _i64,
     [ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
      ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
      ctypes.POINTER(ctypes.c_uint32), _u8p, ctypes.c_size_t]),
    ("atpu_zstd_set_stats", None,
     [ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
      ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32)]),
    ("atpu_inflate_stream_new", ctypes.c_void_p, [_i32]),
    ("atpu_inflate_stream_free", None, [ctypes.c_void_p]),
    ("atpu_inflate_stream_feed", _i64,
     [ctypes.c_void_p, _u8p, ctypes.c_size_t]),
    ("atpu_inflate_stream_pending", _i64, [ctypes.c_void_p]),
    ("atpu_inflate_stream_tail", _i64, [ctypes.c_void_p]),
    ("atpu_inflate_stream_run", _i64,
     [ctypes.c_void_p, _u8p, ctypes.c_size_t, _i32, ctypes.POINTER(_i32)]),
    ("atpu_bz2_stream_new", ctypes.c_void_p, []),
    ("atpu_bz2_stream_free", None, [ctypes.c_void_p]),
    ("atpu_bz2_stream_feed", _i64, [ctypes.c_void_p, _u8p, ctypes.c_size_t]),
    ("atpu_bz2_stream_pending", _i64, [ctypes.c_void_p]),
    ("atpu_bz2_stream_run", _i64,
     [ctypes.c_void_p, _u8p, ctypes.c_size_t, _i32, ctypes.POINTER(_i32)]),
]


def _build() -> None:
    subprocess.run(["make", "-C", _CSRC, "-s"], check=True)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = [os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                if f.endswith(".cpp")]
        if (not os.path.exists(_LIBPATH)
                or any(os.path.getmtime(s) > os.path.getmtime(_LIBPATH)
                       for s in srcs)):
            _build()
        lib = ctypes.CDLL(_LIBPATH)
        for name, restype, argtypes in _SIGNATURES:
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def _as_u8p(buf: np.ndarray):
    return buf.ctypes.data_as(_u8p)


def _tobuf(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8)


# --- zero-copy output buffers -------------------------------------------------
# The codec writes straight into an uninitialized `bytes` object (the
# CPython pattern for building a bytes in place while holding the sole
# reference), which is then returned as is or cut to its written length.

_PyBytes_FromStringAndSize = ctypes.pythonapi.PyBytes_FromStringAndSize
_PyBytes_FromStringAndSize.restype = ctypes.py_object
_PyBytes_FromStringAndSize.argtypes = [ctypes.c_void_p, ctypes.c_ssize_t]
_PyBytes_AsString = ctypes.pythonapi.PyBytes_AsString
_PyBytes_AsString.restype = ctypes.c_void_p
_PyBytes_AsString.argtypes = [ctypes.py_object]


def _alloc_out(cap: int):
    """(bytes object, u8 pointer) over `cap` uninitialized bytes."""
    obj = _PyBytes_FromStringAndSize(None, max(cap, 1))
    ptr = ctypes.cast(_PyBytes_AsString(obj), _u8p)
    return obj, ptr


def _finish_out(obj: bytes, n: int) -> bytes:
    """Finalize an _alloc_out buffer at its written length."""
    if len(obj) == n:
        return obj
    return ctypes.string_at(_PyBytes_AsString(obj), n)


# --- LZ4 --------------------------------------------------------------------

def lz4_compress_bound(n: int) -> int:
    return get_lib().atpu_lz4_compress_bound(n)


def lz4_compress(data: bytes, accel: int = 1) -> bytes:
    lib = get_lib()
    src = _tobuf(data)
    cap = lib.atpu_lz4_compress_bound(len(data))
    ref, dp = _alloc_out(cap)
    n = lib.atpu_lz4_compress(_as_u8p(src), len(data), dp, cap, accel)
    if n < 0:
        raise ValueError("lz4 host compress failed")
    return _finish_out(ref, n)


def lz4_compress_tail(data: bytes, accel: int = 1) -> tuple:
    """Compress and also return the trailing-literal count of the final
    literal-only sequence (needed by the RAP boundary stitcher)."""
    lib = get_lib()
    src = _tobuf(data)
    cap = lib.atpu_lz4_compress_bound(len(data))
    ref, dp = _alloc_out(cap)
    tail = _i64(0)
    n = lib.atpu_lz4_compress_tail(_as_u8p(src), len(data), dp,
                                   cap, accel, ctypes.byref(tail))
    if n < 0:
        raise ValueError("lz4 host compress failed")
    return _finish_out(ref, n), tail.value


def lz4hc_compress(data: bytes, level: int = 9) -> bytes:
    lib = get_lib()
    src = _tobuf(data)
    cap = lib.atpu_lz4_compress_bound(len(data))
    ref, dp = _alloc_out(cap)
    n = lib.atpu_lz4hc_compress(_as_u8p(src), len(data), dp, cap, level)
    if n < 0:
        raise ValueError("lz4hc host compress failed")
    return _finish_out(ref, n)


def lz4hc_compress_tail(data: bytes, level: int = 9) -> tuple:
    """lz4hc_compress plus the final sequence's literal count (stitcher
    input), as lz4_compress_tail."""
    lib = get_lib()
    src = _tobuf(data)
    cap = lib.atpu_lz4_compress_bound(len(data))
    ref, dp = _alloc_out(cap)
    tail = _i64(0)
    n = lib.atpu_lz4hc_compress_tail(_as_u8p(src), len(data), dp,
                                     cap, level, ctypes.byref(tail))
    if n < 0:
        raise ValueError("lz4hc host compress failed")
    return _finish_out(ref, n), tail.value


# Bytes past dstCap in every decode buffer: the library's short-match fast
# path (csrc/lz4_host.cpp:375-384) writes 20 bytes without checking the
# room left, so a valid stream whose long literal run brings the output
# near its end followed by a short match writes up to 16 bytes past dstCap.
_DECODE_SLACK = 64


def lz4_decompress(data: bytes, expected_size: int) -> bytes:
    lib = get_lib()
    src = _tobuf(data)
    ref, dp = _alloc_out(expected_size + _DECODE_SLACK)
    n = lib.atpu_lz4_decompress(_as_u8p(src), len(data), dp, expected_size)
    if n < 0:
        raise ValueError("lz4 host decompress failed (corrupt stream?)")
    return _finish_out(ref, n)


def lz4_decompressed_size(data: bytes) -> int:
    """Exact decompressed size from a structural token scan (no byte
    movement); -1 if the stream structure is malformed."""
    lib = get_lib()
    src = _tobuf(data)
    return int(lib.atpu_lz4_decompressed_size(_as_u8p(src), len(data)))


def lz4_compress_continue(block: bytes, history: bytes,
                          accel: int = 1) -> bytes:
    """Compress one linked block of an LZ4 frame: matches may reference
    `history` (the previous <= 64 KiB of the stream)."""
    lib = get_lib()
    hist = history[-65536:]
    joined = _tobuf(hist + block)
    cap = lib.atpu_lz4_compress_bound(len(block))
    ref, dp = _alloc_out(cap)
    srcp = ctypes.cast(_as_u8p(joined), ctypes.c_void_p).value or 0
    n = lib.atpu_lz4_compress_continue(
        ctypes.cast(srcp + len(hist), _u8p), len(block), dp, cap, accel,
        len(hist))
    if n < 0:
        raise ValueError("lz4 linked-block compress failed")
    return _finish_out(ref, n)


def lz4_decompress_with_history(data: bytes, expected_size: int,
                                history: bytes) -> bytes:
    """Decode an LZ4 block whose back-references may reach into `history`
    (linked blocks of an LZ4 frame). Unlike lz4_decompress this needs no
    _DECODE_SLACK: atpu_lz4_decompress_dict checks every literal run and
    match against dstCap, and takes its 32- and 8-byte copy ladders only
    with mlen + 32 (resp. mlen + 8) bytes of room left
    (csrc/lz4_host.cpp:1016-1031), so no write passes dstCap."""
    lib = get_lib()
    src = _tobuf(data)
    hist = _tobuf(history) if history else np.empty(0, dtype=np.uint8)
    ref, dp = _alloc_out(expected_size)
    n = lib.atpu_lz4_decompress_dict(
        _as_u8p(src), len(data), dp, expected_size,
        _as_u8p(hist) if len(history) else _u8p(), len(history))
    if n < 0:
        raise ValueError("lz4 dict decompress failed (corrupt stream?)")
    return _finish_out(ref, n)


# --- xxHash (LZ4 frame checksums) --------------------------------------------

def xxh32(data: bytes, seed: int = 0) -> int:
    if len(data) == 0:
        return get_lib().atpu_xxh32(_u8p(), 0, seed)
    return get_lib().atpu_xxh32(_as_u8p(_tobuf(data)), len(data), seed)


def xxh64(data: bytes, seed: int = 0) -> int:
    return int(get_lib().atpu_xxh64(_as_u8p(_tobuf(data)), len(data), seed))


class XXH32Stream:
    """Incremental XXH32 (atpu_xxh32_init / update / digest over a 48-byte
    opaque state): an LZ4 frame's content checksum without buffering."""

    def __init__(self, seed: int = 0):
        self._lib = get_lib()
        self._st = ctypes.create_string_buffer(48)
        self._lib.atpu_xxh32_init(ctypes.cast(self._st, ctypes.c_void_p),
                                  seed)

    def update(self, data: bytes) -> None:
        if not data:
            return
        buf = _tobuf(data)
        self._lib.atpu_xxh32_update(
            ctypes.cast(self._st, ctypes.c_void_p), _as_u8p(buf), len(data))

    def digest(self) -> int:
        return int(self._lib.atpu_xxh32_digest(
            ctypes.cast(self._st, ctypes.c_void_p)))


# --- Snappy -----------------------------------------------------------------
# The snappy decoder and inflate hold every write inside dstCap (snappy's
# fast loop keeps its margins against the physical capacity, inflate
# checks each copy against it), so their buffers need no slack.

def snappy_max_compressed_length(n: int) -> int:
    return get_lib().atpu_snappy_max_compressed_length(n)


def snappy_compress(data: bytes) -> bytes:
    lib = get_lib()
    src = _tobuf(data)
    cap = lib.atpu_snappy_max_compressed_length(len(data))
    ref, dp = _alloc_out(cap)
    n = lib.atpu_snappy_compress(_as_u8p(src), len(data), dp, cap)
    if n < 0:
        raise ValueError("snappy host compress failed")
    return _finish_out(ref, n)


def snappy_uncompressed_length(data: bytes) -> int:
    n = get_lib().atpu_snappy_uncompressed_length(_as_u8p(_tobuf(data)),
                                                  len(data))
    if n < 0:
        raise ValueError("snappy: bad length preamble")
    return n


def snappy_uncompress(data: bytes) -> bytes:
    lib = get_lib()
    src = _tobuf(data)
    expected = snappy_uncompressed_length(data)
    ref, dp = _alloc_out(expected)
    n = lib.atpu_snappy_uncompress(_as_u8p(src), len(data), dp, expected)
    if n < 0:
        raise ValueError("snappy host decompress failed (corrupt stream?)")
    return _finish_out(ref, n)


# --- deflate / zlib (csrc/deflate.cpp) ----------------------------------------

DEFLATE_ZLIB, DEFLATE_RAW, DEFLATE_SYNC_CHUNK = 0, 1, 2


def deflate(data: bytes, level: int = 6, mode: int = DEFLATE_ZLIB) -> bytes:
    """DEFLATE encoder: mode 0 = zlib stream, 1 = raw (final block),
    2 = raw sync-flushed chunk (RAP container format)."""
    lib = get_lib()
    src = _tobuf(data)
    cap = lib.atpu_deflate_bound(len(data)) + 16
    ref, dp = _alloc_out(cap)
    n = lib.atpu_deflate(_as_u8p(src), len(data), dp, cap, level, mode)
    if n < 0:
        raise ValueError("deflate failed")
    return _finish_out(ref, n)


def inflate(data: bytes, expected_size: Optional[int] = None,
            raw: bool = False) -> bytes:
    """DEFLATE decoder (zlib stream verified via adler32, or raw)."""
    lib = get_lib()
    src = _tobuf(data)
    cap = expected_size if expected_size is not None else max(
        64, 4 * len(data))
    while True:
        ref, dp = _alloc_out(cap)
        n = lib.atpu_inflate(_as_u8p(src), len(data), dp, max(cap, 1),
                             1 if raw else 0)
        if n >= 0:
            return _finish_out(ref, n)
        if n == -2 and expected_size is None and cap < (1 << 31):
            cap *= 4
            continue
        if n == -4:
            raise ValueError("zlib: adler32 mismatch")
        raise ValueError("inflate: corrupt stream")


def inflate_consumed(data: bytes):
    """Raw inflate returning (decoded, source bytes consumed), so framing
    layers (gzip members) can locate their trailers."""
    lib = get_lib()
    src = _tobuf(data)
    cap = max(64, 4 * len(data))
    consumed = ctypes.c_size_t(0)
    while True:
        ref, dp = _alloc_out(cap)
        n = lib.atpu_inflate_consumed(_as_u8p(src), len(data), dp, cap,
                                      ctypes.byref(consumed))
        if n >= 0:
            return _finish_out(ref, n), int(consumed.value)
        if n == -2 and cap < (1 << 31):
            cap *= 4
            continue
        raise ValueError("inflate: corrupt stream")


def crc32(data: bytes, start: int = 0) -> int:
    """CRC-32 (the gzip / xz polynomial)."""
    src = _tobuf(data)
    return int(get_lib().atpu_crc32(_as_u8p(src) if len(data) else None,
                                    len(data), start & 0xFFFFFFFF))


def adler32(data: bytes, start: int = 1) -> int:
    return int(get_lib().atpu_adler32(_as_u8p(_tobuf(data)), len(data),
                                      start))


#: a gzip member header: deflate, no flags, no mtime, unknown OS
GZIP_HEADER = b"\x1f\x8b\x08\x00" + b"\x00" * 4 + b"\x00\xff"


def gzip_compress(data: bytes, level: int = 6) -> bytes:
    """One gzip member (RFC 1952) over the raw deflate encoder."""
    body = deflate(data, level, DEFLATE_RAW)
    return (GZIP_HEADER + body
            + struct.pack("<II", crc32(data), len(data) & 0xFFFFFFFF))


def gzip_decompress(data: bytes) -> bytes:
    """Decode one or more concatenated gzip members; verifies CRC32 and
    ISIZE."""
    out = bytearray()
    pos = 0
    while pos < len(data):
        if len(data) - pos < 18 or data[pos:pos + 2] != b"\x1f\x8b" \
                or data[pos + 2] != 8:
            raise ValueError("gzip: bad header")
        flg = data[pos + 3]
        p = pos + 10
        if flg & 4:  # FEXTRA
            xlen = struct.unpack_from("<H", data, p)[0]
            p += 2 + xlen
        if flg & 8:  # FNAME
            p = data.index(b"\x00", p) + 1
        if flg & 16:  # FCOMMENT
            p = data.index(b"\x00", p) + 1
        if flg & 2:  # FHCRC
            p += 2
        # the member's trailer follows the deflate stream's final block
        decoded, consumed = inflate_consumed(data[p:])
        p += consumed
        want_crc, want_isize = struct.unpack_from("<II", data, p)
        p += 8
        if crc32(decoded) != want_crc:
            raise ValueError("gzip: crc32 mismatch")
        if (len(decoded) & 0xFFFFFFFF) != want_isize:
            raise ValueError("gzip: length mismatch")
        out += decoded
        pos = p
    return bytes(out)


class InflateStream:
    """Resumable inflate over the library's streaming context
    (atpu_inflate_stream_*). Memory stays O(window): consumed input is
    trimmed inside the context each run."""

    _CHUNK = 256 * 1024

    def __init__(self, raw: bool = False):
        self._lib = get_lib()
        self._ctx = self._lib.atpu_inflate_stream_new(1 if raw else 0)
        if not self._ctx:
            raise MemoryError("inflate stream alloc")
        self.done = False

    def __del__(self):
        ctx, self._ctx = getattr(self, "_ctx", None), None
        if ctx:
            self._lib.atpu_inflate_stream_free(ctx)

    def pending_input(self) -> int:
        """Bytes of compressed input buffered."""
        return int(self._lib.atpu_inflate_stream_pending(self._ctx))

    def tail_bytes(self) -> int:
        """Unconsumed whole input bytes (a byte the deflate stream ended in
        the middle of is consumed), so framing layers can locate the
        member trailer."""
        return int(self._lib.atpu_inflate_stream_tail(self._ctx))

    def decode(self, data: bytes, final: bool = False) -> bytes:
        """Feed ``data`` and return whatever decodes now."""
        if self._ctx is None:
            raise ValueError("stream closed")
        if data:
            buf = _tobuf(data)
            if self._lib.atpu_inflate_stream_feed(
                    self._ctx, _as_u8p(buf), len(data)) < 0:
                raise MemoryError("inflate stream feed")
        out = []
        dst = np.empty(self._CHUNK, dtype=np.uint8)
        flag = _i32(0)
        while True:
            n = self._lib.atpu_inflate_stream_run(
                self._ctx, _as_u8p(dst), dst.size, 1 if final else 0,
                ctypes.byref(flag))
            if n == -4:
                raise ValueError("zlib: adler32 mismatch")
            if n < 0:
                raise ValueError("inflate: corrupt stream")
            out.append(dst[:n].tobytes())
            self.done = bool(flag.value)
            # n == 0: no progress without more input (a run stops ~258 B
            # short of dst.size, so a full chunk is not the test)
            if self.done or n == 0:
                break
        return b"".join(out)


def inflate_plan(chunk: bytes):
    """Crack the first deflate block's header of a raw chunk (the device
    inflate's host stage): (bit offset of its symbol section, litlen code
    lengths u8[288], distance code lengths u8[32]), or None for a stored
    or corrupt first block."""
    src = _tobuf(chunk)
    ll = np.zeros(288, np.uint8)
    dl = np.zeros(32, np.uint8)
    boff = _i64()
    r = get_lib().atpu_inflate_plan(_as_u8p(src), len(chunk), _as_u8p(ll),
                                    _as_u8p(dl), ctypes.byref(boff))
    if r <= 0:
        return None
    return int(boff.value), ll, dl


# --- bzip2 (csrc/bzip2.cpp) ------------------------------------------------

def bz2_compress(data: bytes, level: int = 9) -> bytes:
    lib = get_lib()
    src = _tobuf(data)
    cap = len(data) + len(data) // 2 + 600
    ref, dp = _alloc_out(cap)
    n = lib.atpu_bz2_compress(_as_u8p(src), len(data), dp, cap, level)
    if n < 0:
        raise ValueError("bz2 compress failed")
    return _finish_out(ref, n)


def bz2_decompress(data: bytes, expected_size: Optional[int] = None) -> bytes:
    lib = get_lib()
    src = _tobuf(data)
    cap = expected_size if expected_size is not None else max(
        256, 8 * len(data))
    while True:
        ref, dp = _alloc_out(cap)
        n = lib.atpu_bz2_decompress(_as_u8p(src), len(data), dp,
                                    max(cap, 1))
        if n >= 0:
            return _finish_out(ref, n)
        if n == -2 and expected_size is None and cap < (1 << 31):
            cap *= 4
            continue
        if n == -4:
            raise ValueError("bz2: CRC mismatch")
        raise ValueError("bz2: corrupt stream")


def bz2_prepare(data: bytes, level: int):
    """RLE1, the block split and each block's CRC (the device-BWT tier's
    host stage): (rle1 buffer, offsets, lens, crcs)."""
    lib = get_lib()
    src = _tobuf(data)
    rle = np.empty(len(data) + len(data) // 2 + 64, dtype=np.uint8)
    max_blocks = rle.size // (100000 * level) + 2
    offs = np.empty(max_blocks, dtype=np.int64)
    lens = np.empty(max_blocks, dtype=np.int64)
    crcs = np.empty(max_blocks, dtype=np.uint32)
    nb = lib.atpu_bz2_prepare(
        _as_u8p(src), len(data), level, _as_u8p(rle), rle.size,
        offs.ctypes.data_as(ctypes.POINTER(_i64)),
        lens.ctypes.data_as(ctypes.POINTER(_i64)),
        crcs.ctypes.data_as(_u32p), max_blocks)
    if nb < 0:
        raise ValueError("bz2 prepare failed")
    return rle, offs[:nb], lens[:nb], crcs[:nb]


def bz2_emit(level: int, Ls: bytes, lens, orig_ptrs, crcs) -> bytes:
    """A .bz2 stream from each block's BWT output (L, primary index) and
    CRC: MTF, RLE2 and the Huffman stages on the host."""
    lib = get_lib()
    lsbuf = _tobuf(Ls)
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    origs = np.ascontiguousarray(orig_ptrs, dtype=np.int64)
    crcs32 = np.ascontiguousarray(crcs, dtype=np.uint32)
    total = int(lens64.sum())
    dst = np.empty(total + total // 2 + 600, dtype=np.uint8)
    n = lib.atpu_bz2_emit(
        level, len(lens64), _as_u8p(lsbuf),
        lens64.ctypes.data_as(ctypes.POINTER(_i64)),
        origs.ctypes.data_as(ctypes.POINTER(_i64)),
        crcs32.ctypes.data_as(_u32p), _as_u8p(dst), dst.size)
    if n < 0:
        raise ValueError("bz2 emit failed")
    return dst[:n].tobytes()


class Bz2DecodeStream:
    """Resumable bzip2 decode over the library's streaming context
    (atpu_bz2_stream_*). Memory is O(block size): one block's BWT state
    plus pending input; consumed input is trimmed inside the context."""

    _CHUNK = 256 * 1024

    def __init__(self):
        self._lib = get_lib()
        self._ctx = self._lib.atpu_bz2_stream_new()
        if not self._ctx:
            raise MemoryError("bz2 stream alloc")
        self.done = False

    def __del__(self):
        ctx, self._ctx = getattr(self, "_ctx", None), None
        if ctx:
            self._lib.atpu_bz2_stream_free(ctx)

    def pending_input(self) -> int:
        """Bytes of compressed input buffered."""
        return int(self._lib.atpu_bz2_stream_pending(self._ctx))

    def decode(self, data: bytes, final: bool = False) -> bytes:
        """Feed ``data`` and return whatever decodes now."""
        if self._ctx is None:
            raise ValueError("stream closed")
        if data:
            buf = _tobuf(data)
            if self._lib.atpu_bz2_stream_feed(
                    self._ctx, _as_u8p(buf), len(data)) < 0:
                raise MemoryError("bz2 stream feed")
        out = []
        dst = np.empty(self._CHUNK, dtype=np.uint8)
        flag = _i32(0)
        while True:
            n = self._lib.atpu_bz2_stream_run(
                self._ctx, _as_u8p(dst), dst.size, 1 if final else 0,
                ctypes.byref(flag))
            if n == -4:
                raise ValueError("bzip2: block CRC mismatch")
            if n < 0:
                raise ValueError("bzip2: corrupt stream")
            out.append(dst[:n].tobytes())
            self.done = bool(flag.value)
            if self.done or n < dst.size:
                break
        return b"".join(out)


# --- LZMA (csrc/lzma.cpp), FORMAT_ALONE --------------------------------------

def lzma_compress(data: bytes, level: int = 6) -> bytes:
    lib = get_lib()
    src = _tobuf(data)
    cap = len(data) + len(data) // 2 + 256
    ref, dp = _alloc_out(cap)
    n = lib.atpu_lzma_compress(_as_u8p(src), len(data), dp, cap, level)
    if n < 0:
        raise ValueError("lzma compress failed")
    return _finish_out(ref, n)


def lzma_decompress(data: bytes,
                    expected_size: Optional[int] = None) -> bytes:
    lib = get_lib()
    src = _tobuf(data)
    if expected_size is None:
        declared = lib.atpu_lzma_unpacked_size(_as_u8p(src), len(data))
        cap = int(declared) if declared >= 0 else max(256, 8 * len(data))
    else:
        cap = expected_size
    while True:
        ref, dp = _alloc_out(cap)
        n = lib.atpu_lzma_decompress(_as_u8p(src), len(data), dp,
                                     max(cap, 1))
        if n >= 0:
            return _finish_out(ref, n)
        if n == -2 and cap < (1 << 31):
            cap = max(cap * 4, 1024)
            continue
        raise ValueError("lzma: corrupt stream")


def lzma_compress_cand(data: bytes, level: int, cpos, clen, cdist) -> bytes:
    """Candidate-driven LZMA encode (the device match-finder assist's host
    stage): cpos / clen / cdist are the elected sequences, absolute
    positions in ascending order. Every candidate is revalidated, so a bad
    one only shortens a match."""
    lib = get_lib()
    src = _tobuf(data)
    cap = len(data) + (len(data) // 3) + 256 + 13
    dst = np.empty(cap, dtype=np.uint8)
    cp = np.ascontiguousarray(cpos, dtype=np.int64)
    cl = np.ascontiguousarray(clen, dtype=np.int32)
    cd = np.ascontiguousarray(cdist, dtype=np.int32)
    n = lib.atpu_lzma_compress_cand(
        _as_u8p(src), len(data), _as_u8p(dst), cap, level,
        cp.ctypes.data_as(ctypes.POINTER(_i64)),
        cl.ctypes.data_as(ctypes.POINTER(_i32)),
        cd.ctypes.data_as(ctypes.POINTER(_i32)), cp.size)
    if n < 0:
        raise ValueError("lzma candidate compress failed")
    return dst[:n].tobytes()


# --- RAP container ----------------------------------------------------------

def rap_frame_len(n_main: int) -> int:
    return get_lib().atpu_rap_frame_len(n_main)


def rap_write(n_main: int, offsets, lens, dlens) -> bytes:
    lib = get_lib()
    offs = np.ascontiguousarray(offsets, dtype=np.uint32)
    lns = np.ascontiguousarray(lens, dtype=np.uint32)
    dls = np.ascontiguousarray(dlens, dtype=np.uint32)
    dst = np.empty(lib.atpu_rap_frame_len(n_main), dtype=np.uint8)
    n = lib.atpu_rap_write(_as_u8p(dst), dst.size, n_main,
                           offs.ctypes.data_as(_u32p),
                           lns.ctypes.data_as(_u32p),
                           dls.ctypes.data_as(_u32p))
    if n < 0:
        raise ValueError("rap write failed")
    return dst[:n].tobytes()


def rap_parse(data: bytes) -> Optional[tuple]:
    """Returns (offsets, lens, dlens) arrays, or None for a legacy stream.

    The RAP header stores the chunk count in a 2-byte field, so one frame
    describes at most 65,535 chunks.
    """
    lib = get_lib()
    src = _tobuf(data)
    cap = 1 << 16
    offs = np.empty(cap, dtype=np.uint32)
    lns = np.empty(cap, dtype=np.uint32)
    dls = np.empty(cap, dtype=np.uint32)
    n = lib.atpu_rap_parse(_as_u8p(src), len(data),
                           offs.ctypes.data_as(_u32p),
                           lns.ctypes.data_as(_u32p),
                           dls.ctypes.data_as(_u32p), cap)
    if n < 0:
        raise ValueError("malformed RAP frame")
    if n == 0:
        return None
    return offs[:n].copy(), lns[:n].copy(), dls[:n].copy()


def rap_skip(data: bytes) -> int:
    """Bytes to skip past a RAP frame (0 if none) — aocl_skip_rap_frame_mt."""
    return get_lib().atpu_rap_skip(_as_u8p(_tobuf(data)), len(data))


def rap_frame_bound(src_size: int, chunk_size: int) -> int:
    return get_lib().atpu_rap_frame_bound(src_size, chunk_size)


# --- zstd (csrc/zstd_encode.cpp, csrc/zstd_decode.cpp) ------------------------

def zstd_compress(data: bytes, level: int = 3,
                  dictionary: Optional[bytes] = None,
                  checksum: bool = False) -> bytes:
    """The library's zstd encoder, levels -64..22, with an optional
    raw-content or structured dictionary and Content_Checksum."""
    lib = get_lib()
    src = _tobuf(data)
    d = _tobuf(dictionary) if dictionary else None
    cap = lib.atpu_zstd_compress_bound(len(data)) + 64
    ref, dp = _alloc_out(cap)
    n = lib.atpu_zstd_compress_ex(
        _as_u8p(src), len(data), dp, cap, level,
        _as_u8p(d) if d is not None and d.size else None,
        int(d.size) if d is not None else 0, 1 if checksum else 0)
    if n < 0:
        raise ValueError("zstd compress failed")
    return _finish_out(ref, n)


def zstd_frame_content_size(data: bytes) -> Optional[int]:
    """Declared content size of the first frame, or None if unknown."""
    n = get_lib().atpu_zstd_frame_content_size(_as_u8p(_tobuf(data)),
                                               len(data))
    return int(n) if n >= 0 else None


def zstd_decompress(data: bytes, expected_size: Optional[int] = None,
                    dictionary: Optional[bytes] = None) -> bytes:
    """Decode a stream of concatenated zstd frames (skippable ones too).

    Capacity: expected_size if given, else the sum of the declared frame
    content sizes when every frame declares one, else a guess that grows
    on the decoder's dst-too-small error."""
    if not data:
        return b""
    lib = get_lib()
    src = _tobuf(data)
    d = _tobuf(dictionary) if dictionary else None
    dp = _as_u8p(d) if d is not None and d.size else None
    dlen = int(d.size) if d is not None else 0
    if expected_size is not None:
        cap = max(1, expected_size)
    else:
        total, off = 0, 0
        while off < len(data):
            view = src[off:]
            fsz = lib.atpu_zstd_frame_compressed_size(_as_u8p(view),
                                                      len(data) - off)
            csz = lib.atpu_zstd_frame_content_size(_as_u8p(view),
                                                   len(data) - off)
            if fsz <= 0 or csz < 0:
                total = -1
                break
            total += int(csz)
            off += int(fsz)
        if total >= 0 and off == len(data):
            cap = max(1, total)
        else:
            probe = lib.atpu_zstd_frame_content_size(_as_u8p(src), len(data))
            cap = max(64, int(probe) * 2 + 64) if probe > 0 else \
                max(64, 4 * len(data))
    while True:
        ref, outp = _alloc_out(cap)
        n = lib.atpu_zstd_decompress(_as_u8p(src), len(data), outp, cap, dp,
                                     dlen)
        if n >= 0:
            return _finish_out(ref, n)
        if n == -2 and cap < (1 << 31):  # dst too small
            cap *= 4
            continue
        if n == -4:
            raise ValueError("zstd: content checksum mismatch")
        if n == -3:
            raise ValueError("zstd: bad dictionary")
        raise ValueError("zstd: corrupt stream")


def zstd_decompress_frame(data: bytes):
    """Decode ONE zstd frame from the head of `data`: (decoded bytes,
    source bytes consumed), or None when `data` does not hold a whole
    frame yet (a stream waits for more input). Raises on corruption. A
    skippable frame decodes to b"" and is consumed."""
    if len(data) < 8:
        return None
    lib = get_lib()
    src = _tobuf(data)
    fsz = lib.atpu_zstd_frame_compressed_size(_as_u8p(src), len(data))
    if fsz == -5:  # incomplete frame
        return None
    if fsz < 0:
        raise ValueError("zstd: corrupt frame")
    probe = lib.atpu_zstd_frame_content_size(_as_u8p(src), len(data))
    cap = max(64, int(probe) * 2 + 64) if probe > 0 else max(
        64, 4 * int(fsz))
    consumed = ctypes.c_size_t(0)
    while True:
        ref, dp = _alloc_out(cap)
        n = lib.atpu_zstd_decompress_frame(
            _as_u8p(src), int(fsz), dp, cap, None, 0, ctypes.byref(consumed))
        if n >= 0:
            if consumed.value == 0 or consumed.value > len(data):
                return None
            return _finish_out(ref, n), int(consumed.value)
        if n == -2 and cap < (1 << 31):
            cap *= 4
            continue
        raise ValueError("zstd: corrupt frame")


def zstd_build_dict_header(lit_freq, dict_id: int, ll_freq=None,
                           of_freq=None, ml_freq=None) -> bytes:
    """A structured dictionary's entropy header: magic, dictID, the Huffman
    table of the literal histogram, FSE tables from the code histograms
    where given (else predefined) and the default repcodes; the trainer
    appends the content after it."""
    lib = get_lib()
    freq = (ctypes.c_uint32 * 256)(*[int(x) for x in lit_freq])

    def arr(x, n):
        return (ctypes.c_uint32 * n)(*[int(v) for v in x]) if x is not None \
            else None
    cap = 1024
    ref, dp = _alloc_out(cap)
    n = lib.atpu_zstd_build_dict_header(
        freq, dict_id & 0xFFFFFFFF, arr(ll_freq, 36), arr(of_freq, 32),
        arr(ml_freq, 53), dp, cap)
    if n < 0:
        raise ValueError("zstd dict header build failed")
    return _finish_out(ref, n)


class ZstdStatsCapture:
    """Histograms of the literals and sequence codes that zstd_compress
    calls emit inside the `with` block (the dictionary trainer's statistics
    pass). The capture is one process-wide slot in the library: not
    thread-safe."""

    def __enter__(self):
        lib = get_lib()
        self.lit = (ctypes.c_uint32 * 256)()
        self.ll = (ctypes.c_uint32 * 36)()
        self.of = (ctypes.c_uint32 * 32)()
        self.ml = (ctypes.c_uint32 * 53)()
        lib.atpu_zstd_set_stats(self.lit, self.ll, self.of, self.ml)
        return self

    def __exit__(self, *exc):
        get_lib().atpu_zstd_set_stats(None, None, None, None)
        return False


# Columns of one block's plan row; must equal ops/zstd_decode_device's
# PLAN_STRIDE (the PM_* layout of csrc/zstd_decode.cpp).
_PLAN_STRIDE = 22
_PLAN_MAXBLOCKS = 512


def zstd_frame_plan(data: bytes, off: int = 0,
                    max_blocks: int = _PLAN_MAXBLOCKS):
    """Crack ONE zstd frame's headers into a device decode plan
    (atpu_zstd_frame_plan). Returns (nblocks, meta, huf, fse, consumed):
    nblocks == 0 for a skippable frame, -1 for a frame of more than
    max_blocks blocks (the caller decodes it on the host); None when the
    frame is corrupt. meta is int32 (nblocks, 22), huf uint16 (nblocks,
    2048), fse uint32 (nblocks, 3, 512); offsets in meta are absolute."""
    lib = get_lib()
    view = np.frombuffer(data, dtype=np.uint8)[off:]
    meta = np.zeros((max_blocks, _PLAN_STRIDE), np.int32)
    huf = np.zeros((max_blocks, 2048), np.uint16)
    fse = np.zeros((max_blocks, 3, 512), np.uint32)
    consumed = _i64(0)
    nb = lib.atpu_zstd_frame_plan(
        _as_u8p(view), view.size, meta.ctypes.data_as(ctypes.POINTER(_i32)),
        huf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        fse.ctypes.data_as(_u32p), max_blocks, ctypes.byref(consumed))
    if nb == -2 and consumed.value > 0:   # more blocks than max_blocks
        return -1, None, None, None, int(consumed.value)
    if nb < 0:
        return None
    m = meta[:nb]
    if nb and off:
        # stream and section offsets are relative to the view; entries that
        # are unused (zero) are shifted too, and never read
        for col in (1, 7, 9, 11, 13, 16):  # PM_BOFF, PM_S*OFF, PM_SEQOFF
            m[:, col] += off
    return int(nb), m, huf[:nb], fse[:nb], int(consumed.value)
