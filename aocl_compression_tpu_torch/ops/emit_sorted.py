"""Wrappers of the sort-emit serializer kernels (csrc/emit_sorted.cu).

Two hand kernels for sm_90a, built with nvcc into _build/ at first use and
bound with ctypes, as ops/match_find.py builds match_find.cu. They compute
the last stage of the lz4 and snappy tile encoders:

  emit_lz4     ops/lz4_device._emit_sorted: the LZ4 body of each row from
               its tile parse, every output byte written at its rank among
               the row's output positions (no sort);
  emit_snappy  ops/snappy_device._emit_snappy_sorted: the same for the
               snappy element format.

Each wrapper takes CUDA tensors only (the tile fields may be strided views,
as _grid_select returns them), allocates its outputs with torch.empty,
launches on the current stream and raises when the launch fails (there is
no fallback). Their plain PyTorch versions (_emit_sorted_plain,
_emit_snappy_sorted_plain) live beside their callers, which pick the
kernel for a CUDA tensor and the plain version for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import compact

_SRC = os.path.join(compact._PKG, "csrc", "emit_sorted.cu")
_LIB = os.path.join(compact._BUILD, "libatpu_emit_sorted.so")

MAX_BLOCK = 65536     # positions are packed into 16 bits
_FORMATS = {"emit_lz4": 0, "emit_snappy": 1}
_lib = None
_lock = threading.Lock()

#: kernel launches since the last reset, one per wrapper call (bumped
#: under _lock: the multi-device tier's shards launch from several threads)
launches = {"emit_lz4": 0, "emit_snappy": 0}

#: nvcc's output of the last build in this process (ptxas resource usage)
build_log = ""


def build() -> str:
    """Compile csrc/emit_sorted.cu into _build/ (if stale) and return the
    library path. Raises if nvcc fails."""
    global build_log
    log = compact.nvcc_build(_SRC, _LIB)
    if log:
        build_log = log
    return _LIB


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.atpu_emit_sorted.restype = i
            lib.atpu_emit_sorted.argtypes = (
                [i] + [p] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
                + [p] * 4 + [i] * 3 + [p])
            _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype, shape, dev,
           contiguous: bool = True) -> None:
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"{name} must be a CUDA tensor on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _emit(kernel: str, data_u8, n, sel, cpos, cml, coff, B: int, G: int):
    if data_u8.dim() != 2 or not 1 <= B <= MAX_BLOCK or G < 1 or B % G:
        raise ValueError(f"{kernel} takes (N, B) rows with 1 <= B <= "
                         f"{MAX_BLOCK} and G dividing B, got "
                         f"{tuple(data_u8.shape)}, B={B}, G={G}")
    dev = data_u8.device
    N, M = data_u8.shape[0], B // G
    _check("data_u8", data_u8, torch.uint8, (N, B), dev)
    _check("n", n, torch.int32, (N,), dev)
    _check("sel", sel, torch.bool, (N, M), dev, contiguous=False)
    for name, t in (("cpos", cpos), ("cml", cml), ("coff", coff)):
        _check(name, t, torch.int32, (N, M), dev, contiguous=False)
    out = torch.empty((N, B), dtype=torch.uint8, device=dev)
    body = torch.empty((N,), dtype=torch.int32, device=dev)
    tail = torch.empty((N,), dtype=torch.int32, device=dev)
    flag = torch.empty((N,), dtype=torch.bool, device=dev)
    if N:
        strides = (ctypes.c_longlong * 8)(
            *(s for t in (sel, cpos, cml, coff) for s in t.stride()))
        with torch.cuda.device(dev):
            err = _get_lib().atpu_emit_sorted(
                _FORMATS[kernel], data_u8.data_ptr(), n.data_ptr(),
                sel.data_ptr(), cpos.data_ptr(), cml.data_ptr(),
                coff.data_ptr(), strides, out.data_ptr(), body.data_ptr(),
                tail.data_ptr(), flag.data_ptr(), N, B, G,
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                               f"{err}")
        with _lock:
            launches[kernel] += 1
    return out, body, tail, flag


def emit_lz4(data_u8, n, sel, cpos, cml, coff, B: int, G: int):
    """data_u8 (N, B) uint8, n (N,) int32, the tile parse sel (N, M) bool
    and cpos, cml, coff (N, M) int32 (M = B // G) -> (out (N, B) uint8,
    body (N,) int32, tail (N,) int32, flag (N,) bool), as
    lz4_device._emit_sorted_plain gives them."""
    return _emit("emit_lz4", data_u8, n, sel, cpos, cml, coff, B, G)


def emit_snappy(data_u8, n, sel, cpos, cml, coff, B: int, G: int):
    """The snappy format's counterpart of emit_lz4, as
    snappy_device._emit_snappy_sorted_plain gives it."""
    return _emit("emit_snappy", data_u8, n, sel, cpos, cml, coff, B, G)

