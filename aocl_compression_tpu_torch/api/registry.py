"""Codec registry — method enum -> codec instance.

Parity with the reference's static aocl_codec[] table (api/codec.h:155-174).
The enum lists all seven methods, and all seven are registered; an unknown
method raises UNSUPPORTED_METHOD at setup. Excluded codecs
(config.enabled_codecs) raise EXCLUDED_METHOD, like the reference's
compile-time exclusion.
"""

from __future__ import annotations

import enum
from typing import Dict

from ..utils.config import get_config
from .errors import ExcludedMethodError, UnsupportedMethodError


class Method(enum.IntEnum):
    """Parity with aocl_compression_type (api/aocl_compression.h:76-92)."""
    LZ4 = 0
    LZ4HC = 1
    LZMA = 2
    BZIP2 = 3
    SNAPPY = 4
    ZLIB = 5
    ZSTD = 6


_codecs: Dict[str, "object"] = {}


def _build_registry() -> None:
    if _codecs:
        return
    from ..codecs.lz4 import Lz4Codec
    from ..codecs.lz4hc import Lz4hcCodec
    from ..codecs.snappy import SnappyCodec
    from ..codecs.zlib_bzip2_lzma import Bzip2Codec, LzmaCodec, ZlibCodec
    from ..codecs.zstd import ZstdCodec
    for codec in (Lz4Codec(), Lz4hcCodec(), SnappyCodec(), ZlibCodec(),
                  ZstdCodec(), Bzip2Codec(), LzmaCodec()):
        _codecs[codec.name] = codec


def normalize_method(method) -> str:
    if isinstance(method, Method):
        return method.name.lower()
    if isinstance(method, int):
        return Method(method).name.lower()
    return str(method).lower()


def get_codec(method):
    _build_registry()
    name = normalize_method(method)
    if name not in _codecs:
        raise UnsupportedMethodError(name)
    if name not in get_config().enabled_codecs:
        raise ExcludedMethodError(name)
    return _codecs[name]


def list_codecs():
    _build_registry()
    return [_codecs[m.name.lower()] for m in Method
            if m.name.lower() in _codecs]
