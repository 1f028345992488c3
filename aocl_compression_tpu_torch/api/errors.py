"""Error codes + exceptions.

Parity with aocl_error_type (reference api/aocl_compression.h:95-102): the
negative integer codes match the reference.
"""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    OK = 0
    COMPRESSION_FAILED = -1
    DECOMPRESSION_FAILED = -2
    UNSUPPORTED_METHOD = -3
    EXCLUDED_METHOD = -4
    COMPRESSION_INVALID_OUTPUT_SIZE = -5
    INVALID_INPUT = -6


class CompressionError(Exception):
    def __init__(self, code: ErrorCode, msg: str = ""):
        self.code = code
        super().__init__(f"{code.name}: {msg}" if msg else code.name)


class UnsupportedMethodError(CompressionError):
    def __init__(self, msg: str = ""):
        super().__init__(ErrorCode.UNSUPPORTED_METHOD, msg)


class ExcludedMethodError(CompressionError):
    def __init__(self, msg: str = ""):
        super().__init__(ErrorCode.EXCLUDED_METHOD, msg)
