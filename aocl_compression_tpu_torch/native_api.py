"""Native-API surface: each codec's upstream-named entry points.

The reference exports every codec's native upstream API beside the unified
one (LZ4_compress_default, compress2, BZ2_bzBuffToBuffCompress,
LzmaEncode, snappy::RawCompress, ZSTD_compressCCtx, ...) and lazily
initializes a default context when a native API is called without
aocl_llc_setup (AOCL_SETUP_NATIVE). These are the JAX package's thin
equivalents with upstream naming and semantics, on lazily created
per-codec handles of the port's unified API. Bytes in, bytes out replaces
the C (dst, dstCapacity) out-parameters; *_bound functions mirror the
capacity helpers.

Every entry point that opens a handle takes ``device``, passed to
``setup``: None means ``cuda``, which raises where there is none; pass
``device="cpu"`` to run on the CPU. A handle is cached per codec, options
and resolved device. The entry points keep the tiers they have in the JAX
package: LZ4_compress_fast with acceleration >= 2 (and LZ4F_compressFrame
given a device max_tier) reaches the device tier, the others run the host
tier.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, Optional

from .api import unified
from .api.handle import Handle
from .runtime import native
from .utils.device import resolve_device

_lock = threading.Lock()
_handles: Dict[tuple, Handle] = {}


def _handle(codec: str, device=None, **kw) -> Handle:
    """Lazy default handle per (codec, options, device): AOCL_SETUP_NATIVE
    parity."""
    dev = resolve_device(device)
    key = (codec, str(dev), tuple(sorted(kw.items())))
    with _lock:
        h = _handles.get(key)
        if h is None:
            h = unified.setup(codec, device=dev, **kw)
            _handles[key] = h
        return h


# --- LZ4 ---------------------------------------------------------------------

def LZ4_compressBound(input_size: int) -> int:
    return input_size + input_size // 255 + 16


def LZ4_compress_default(src: bytes, device=None) -> bytes:
    return unified.compress(_handle("lz4", device, enable_rap=False), src)


def LZ4_compress_fast(src: bytes, acceleration: int = 1,
                      device=None) -> bytes:
    """acceleration >= 2 runs the device encoder on ``device``."""
    return unified.compress(
        _handle("lz4", device, enable_rap=False,
                opt_var=max(1, acceleration)), src)


def LZ4_decompress_safe(src: bytes, dst_capacity: int,
                        device=None) -> bytes:
    return unified.decompress(_handle("lz4", device, enable_rap=False), src,
                              expected_size=dst_capacity)


# --- LZ4HC -------------------------------------------------------------------

def LZ4_compress_HC(src: bytes, compression_level: int = 9,
                    device=None) -> bytes:
    return unified.compress(
        _handle("lz4hc", device, enable_rap=False, level=compression_level),
        src)


# --- Snappy ------------------------------------------------------------------

def snappy_compress(src: bytes, device=None) -> bytes:
    return unified.compress(_handle("snappy", device, enable_rap=False), src)


def snappy_uncompress(src: bytes, device=None) -> bytes:
    return unified.decompress(_handle("snappy", device, enable_rap=False),
                              src)


def snappy_max_compressed_length(n: int) -> int:
    return 32 + n + n // 6


def snappy_uncompressed_length(src: bytes) -> int:
    return native.snappy_uncompressed_length(src)


# --- zlib --------------------------------------------------------------------

def compress2(src: bytes, level: int = 6, device=None) -> bytes:
    return unified.compress(
        _handle("zlib", device, enable_rap=False, level=level), src)


def uncompress(src: bytes, dest_len: Optional[int] = None,
               device=None) -> bytes:
    return unified.decompress(_handle("zlib", device, enable_rap=False), src,
                              expected_size=dest_len)


def compressBound(n: int) -> int:
    return n + (n >> 12) + (n >> 14) + (n >> 25) + 13


# --- bzip2 -------------------------------------------------------------------

def BZ2_bzBuffToBuffCompress(src: bytes, block_size_100k: int = 9,
                             work_factor: int = 0, device=None) -> bytes:
    return unified.compress(_handle("bzip2", device, level=block_size_100k),
                            src)


def BZ2_bzBuffToBuffDecompress(src: bytes, dest_len: Optional[int] = None,
                               device=None) -> bytes:
    return unified.decompress(_handle("bzip2", device), src,
                              expected_size=dest_len)


# --- LZMA --------------------------------------------------------------------

def LzmaEncode(src: bytes, level: int = 6, device=None) -> bytes:
    """props (5 B) + raw stream, the reference adapter's layout before it
    splices in the unified buffer: FORMAT_ALONE is props + 8-byte size +
    stream, so the size field is cut out."""
    full = unified.compress(_handle("lzma", device, level=level), src)
    return full[:5] + full[13:]


def LzmaDecode(src: bytes, unc_len: int, device=None) -> bytes:
    alone = src[:5] + struct.pack("<Q", unc_len) + src[5:]
    return unified.decompress(_handle("lzma", device), alone,
                              expected_size=unc_len)


def lzma_easy_buffer_encode(data: bytes, preset: int = 6) -> bytes:
    """xz-utils-compatible one-shot .xz encode (host; codecs/xz.py)."""
    from .codecs import xz
    return xz.xz_compress(data, preset)


def lzma_stream_buffer_decode(data: bytes) -> bytes:
    """xz-utils-compatible one-shot .xz decode (host)."""
    from .codecs import xz
    return xz.xz_decompress(data)


# --- ZSTD --------------------------------------------------------------------

def ZSTD_compressBound(n: int) -> int:
    return n + (n >> 8) + 64


def ZSTD_compress(src: bytes, level: int = 3, device=None) -> bytes:
    return unified.compress(
        _handle("zstd", device, enable_rap=False, level=level), src)


def ZSTD_decompress(src: bytes, dst_capacity: Optional[int] = None,
                    device=None) -> bytes:
    return unified.decompress(_handle("zstd", device, enable_rap=False), src,
                              expected_size=dst_capacity)


def ZSTD_getFrameContentSize(src: bytes) -> int:
    n = native.zstd_frame_content_size(bytes(src))
    return -1 if n is None else n


def ZDICT_trainFromBuffer(samples, dict_size: int = 16384) -> bytes:
    """Dictionary builder (host; codecs/zstd.train_dictionary)."""
    from .codecs.zstd import train_dictionary
    return train_dictionary(samples, dict_size)


def ZSTD_compress_usingDict(src: bytes, dictionary: bytes, level: int = 3,
                            device=None) -> bytes:
    return unified.compress(
        _handle("zstd", device, enable_rap=False, level=level,
                dictionary=dictionary), src)


def ZSTD_decompress_usingDict(src: bytes, dictionary: bytes,
                              dst_capacity: Optional[int] = None,
                              device=None) -> bytes:
    return unified.decompress(
        _handle("zstd", device, enable_rap=False, dictionary=dictionary),
        src, expected_size=dst_capacity)


# --- LZ4 Frame ---------------------------------------------------------------

def LZ4F_compressFrame(src: bytes, device=None, **opts) -> bytes:
    """codecs.lz4_frame.compress_frame; ``device`` serves a device
    max_tier."""
    from .codecs.lz4_frame import compress_frame
    return compress_frame(src, device=device, **opts)


def LZ4F_decompressFrame(src: bytes) -> bytes:
    from .codecs.lz4_frame import decompress_frame
    return decompress_frame(src)


def XXH32(data: bytes, seed: int = 0) -> int:
    return native.xxh32(data, seed)
