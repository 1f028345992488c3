"""Wrapper of the device inflate's symbol-scan kernel
(csrc/inflate_scan.cu).

inflate_symbol_scan is a hand kernel for sm_90a, one CUDA block per chunk
lane, built with nvcc into _build/ at first use and bound with ctypes, as
ops/zstd_scan.py builds zstd_scan.cu. Its threads fill root decode tables
in shared memory from the lane's canonical-code parameters, then one
thread decodes the lane's literal/length/distance symbols up to its
end-of-block or first bad code, one table lookup per symbol over a bit
buffer in registers fed through a cp.async ring in shared memory, and
writes the compaction's outputs directly (the literal buffer and the
sequence list), so the (kind, val, dist) slots never reach device memory.
ops/inflate_device.root_tables is the tables' plain version.

The wrapper takes CUDA tensors only, allocates its outputs with
torch.empty, launches on the current stream and raises when the launch
fails. Its plain PyTorch version is ops/inflate_device._compact_plain of
_symbol_scan_plain; ops/inflate_device._scan_compact picks the kernel for
a CUDA tensor and the plain version for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import compact
from .zstd_scan import _check

_SRC = os.path.join(compact._PKG, "csrc", "inflate_scan.cu")
_LIB = os.path.join(compact._BUILD, "libatpu_inflate_scan.so")

_lib = None
_lock = threading.Lock()

#: kernel launches since the last reset, one per wrapper call (bumped
#: under _lock, as zstd_scan.launches)
launches = {"inflate_symbol_scan": 0}

#: nvcc's output of the last build in this process (ptxas resource usage)
build_log = ""


def build() -> str:
    """Compile csrc/inflate_scan.cu into _build/ (if stale) and return the
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
            fn = lib.atpu_inflate_symbol_scan
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
            _lib = lib
    return _lib


def inflate_symbol_scan(cbytes, bitoff, fcL, limL, rkbL, permL, fcD, limD,
                        rkbD, permD, B: int, MAXSEQ: int):
    """cbytes (N, C) uint8 (C % 4 == 0), bitoff (N,) int32, fc / lim / rkb
    (N, 16) int32 and perm (N, 288) / (N, 32) int32 for the litlen and
    distance alphabets -> (litbuf (N, B) uint8, ll, ml, off (N, MAXSEQ)
    int32, nbseq (N,) int32, litregen (N,) int32), as
    inflate_device._compact_plain returns them for the scan of MAXS = B + 4
    slots (litbuf is 0 past litregen)."""
    N, C = cbytes.shape
    dev = cbytes.device
    i32 = torch.int32
    if C % 4:
        raise ValueError("inflate_symbol_scan takes 4-byte chunk rows")
    _check("cbytes", cbytes, torch.uint8, (N, C), dev)
    for name, t, shape in (("bitoff", bitoff, (N,)), ("fcL", fcL, (N, 16)),
                           ("limL", limL, (N, 16)), ("rkbL", rkbL, (N, 16)),
                           ("permL", permL, (N, 288)), ("fcD", fcD, (N, 16)),
                           ("limD", limD, (N, 16)), ("rkbD", rkbD, (N, 16)),
                           ("permD", permD, (N, 32))):
        _check(name, t, i32, shape, dev)
    litbuf = torch.empty((N, B), dtype=torch.uint8, device=dev)
    ll = torch.empty((N, MAXSEQ), dtype=i32, device=dev)
    ml = torch.empty_like(ll)
    off = torch.empty_like(ll)
    nbseq = torch.empty(N, dtype=i32, device=dev)
    litregen = torch.empty_like(nbseq)
    lib = _get_lib()
    with torch.cuda.device(dev):
        err = lib.atpu_inflate_symbol_scan(
            cbytes.data_ptr(), bitoff.data_ptr(), fcL.data_ptr(),
            limL.data_ptr(), rkbL.data_ptr(), permL.data_ptr(),
            fcD.data_ptr(), limD.data_ptr(), rkbD.data_ptr(),
            permD.data_ptr(), litbuf.data_ptr(), ll.data_ptr(),
            ml.data_ptr(), off.data_ptr(), nbseq.data_ptr(),
            litregen.data_ptr(), N, C, B, MAXSEQ,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"inflate_symbol_scan kernel launch failed: "
                               f"CUDA error {err}")
        with _lock:
            launches["inflate_symbol_scan"] += 1
    return litbuf, ll, ml, off, nbseq, litregen
