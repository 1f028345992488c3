"""Unified API: setup / compress / decompress / destroy / version.

Parity with the reference's five exported entry points
(api/api.cpp:45-196, api/aocl_compression.h:170-231):

  aocl_llc_setup      -> setup(method, **handle fields) -> Handle
  aocl_llc_compress   -> compress(handle, data) -> bytes
  aocl_llc_decompress -> decompress(handle, data) -> bytes
  aocl_llc_destroy    -> destroy(handle)
  aocl_llc_version    -> version()

The handle's device tiers run on ``handle.device``: setup resolves
``device=None`` to the GPU and raises where there is none. Pass
``device="cpu"`` to run them on the CPU.

When handle.measure_stats is set, compress/decompress record
size/time/speed into handle.stats; device work ends in a device-to-host
copy inside the codec, so the numbers cover it. Errors map to the
reference's negative codes via CompressionError.
"""

from __future__ import annotations

from typing import Optional

from ..utils import logging as log
from ..utils.device import resolve_device
from ..utils.timers import Timer, speed_mbps
from .errors import CompressionError, ErrorCode
from .handle import Handle
from .registry import get_codec, normalize_method

__version_str__ = "AOCL-COMPRESSION-TPU-TORCH 1.0"


def setup(method, device=None, **kwargs) -> Handle:
    """Create and initialize a handle for `method` (name, Method enum or int).

    kwargs are Handle fields (level, opt_var, num_shards, measure_stats,
    opt_off, max_tier, block_size, ...). ``device`` is where the device
    tiers run: None means ``cuda``, which raises if no GPU is present.
    """
    log.log_trace_enter()
    codec = get_codec(method)   # raises UNSUPPORTED/EXCLUDED
    handle = Handle(codec=normalize_method(method),
                    device=resolve_device(device), **kwargs)
    if handle.level == 0 and codec.default_level:
        handle.level = codec.default_level
    codec.setup(handle)
    handle._setup_done = True
    log.log_trace_exit()
    return handle


def compress(handle: Handle, data: bytes) -> bytes:
    """Compress `data`; parity with aocl_llc_compress (api/api.cpp:45-84)."""
    log.log_trace_enter()
    if not isinstance(handle, Handle) or not handle._setup_done:
        raise CompressionError(ErrorCode.INVALID_INPUT, "handle not set up")
    codec = get_codec(handle.codec)
    timer = Timer()
    timer.start()
    try:
        out = codec.compress(handle, bytes(data))
    except CompressionError:
        raise
    except Exception as e:  # reference maps any failure to -1 (:79)
        raise CompressionError(ErrorCode.COMPRESSION_FAILED, str(e)) from e
    timer.stop()
    if handle.measure_stats:
        handle.stats.c_size = len(out)
        handle.stats.c_time_ns = timer.elapsed_ns
        handle.stats.c_speed_mbps = speed_mbps(len(data), timer.elapsed_ns)
    log.log_trace_exit()
    return out


def decompress(handle: Handle, data: bytes,
               expected_size: Optional[int] = None) -> bytes:
    """Decompress `data`; parity with aocl_llc_decompress (api/api.cpp:86-125)."""
    log.log_trace_enter()
    if not isinstance(handle, Handle) or not handle._setup_done:
        raise CompressionError(ErrorCode.INVALID_INPUT, "handle not set up")
    codec = get_codec(handle.codec)
    timer = Timer()
    timer.start()
    try:
        out = codec.decompress(handle, bytes(data), expected_size)
    except CompressionError:
        raise
    except Exception as e:
        raise CompressionError(ErrorCode.DECOMPRESSION_FAILED, str(e)) from e
    timer.stop()
    if handle.measure_stats:
        handle.stats.d_size = len(out)
        handle.stats.d_time_ns = timer.elapsed_ns
        handle.stats.d_speed_mbps = speed_mbps(len(out), timer.elapsed_ns)
    log.log_trace_exit()
    return out


def destroy(handle: Handle) -> None:
    """Release codec work state; parity with aocl_llc_destroy (api/api.cpp:169)."""
    if handle._setup_done:
        get_codec(handle.codec).destroy(handle)
        handle._setup_done = False


def version() -> str:
    """Parity with aocl_llc_version (api/api.cpp:186)."""
    return __version_str__


def compress_bound(method, n: int) -> int:
    """Worst-case compressed size for n input bytes under `method`."""
    return get_codec(method).compress_bound(n)
