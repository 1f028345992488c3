"""Wrappers of the chain-marking kernels (csrc/chain_scan.cu).

Two hand kernels for sm_90a, built with nvcc into _build/ at first use and
bound with ctypes, as ops/entropy_scan.py builds entropy_scan.cu:

  subchain_reach  — the tiles each sub-chain of SUBM tiles reaches from its
                    local 0 (ops/lz4_device._reach_from_start, in
                    _grid_select: every tile encoder's parse); one lane a
                    sub-chain walks its staged targets in shared memory,
                    each warp on its own 32;
  chain_marks     — the positions the chain p -> nxt[p] visits from 0,
                    threaded through 128-position segments in order
                    (ops/lz4_device._chain_marks: the exact parse's greedy
                    chain and the lz4 and snappy decoders' token chains);
                    a thread-block cluster a row (8 CTAs for a lone row,
                    one CTA from 67 rows on; the C launcher picks the size
                    from N and the card's SM count).

Each wrapper takes CUDA tensors only, allocates its output with
torch.empty, launches on the current stream and raises when the launch
fails (a refused cluster or shared-memory configuration included: there
is no fallback). Their plain PyTorch versions live beside their callers,
which pick the kernel for a CUDA tensor and the plain version for a CPU
tensor.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import compact

_SRC = os.path.join(compact._PKG, "csrc", "chain_scan.cu")
_LIB = os.path.join(compact._BUILD, "libatpu_chain_scan.so")

SEG = 128        # chain_marks' segment; also the largest SUBM
_lib = None
_lock = threading.Lock()

#: kernel launches since the last reset, one per wrapper call (bumped
#: under _lock: the multi-device tier's shards launch from several threads)
launches = {"subchain_reach": 0, "chain_marks": 0}

#: nvcc's output of the last build in this process (ptxas resource usage)
build_log = ""


def build() -> str:
    """Compile csrc/chain_scan.cu into _build/ (if stale) and return the
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
            for name, nptr, nint in (("atpu_subchain_reach", 2, 3),
                                     ("atpu_chain_marks", 3, 2)):
                fn = getattr(lib, name)
                fn.restype = i
                fn.argtypes = [p] * nptr + [i] * nint + [p]
            _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, shape, dev) -> None:
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"{name} must be a CUDA tensor on {dev}")
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be int32 of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(kernel: str, fn, dev, *args) -> None:
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    with _lock:
        launches[kernel] += 1


def subchain_reach(nxt: torch.Tensor, subm: int) -> torch.Tensor:
    """nxt (N, M) int32 on the tile domain, M a multiple of subm (1 <= subm
    <= 128) -> reach (N, M) bool: tile t is reachable from its sub-chain's
    local 0 by the edges p -> nxt[p] with 0 <= nxt[p] - base < subm."""
    N, M = nxt.shape
    dev = nxt.device
    if not 1 <= subm <= SEG or M % subm:
        raise ValueError(f"subchain_reach takes 1 <= subm <= {SEG} dividing "
                         f"M, got subm={subm}, M={M}")
    _check("nxt", nxt, (N, M), dev)
    reach = torch.empty((N, M), dtype=torch.bool, device=dev)
    if N and M:
        _launch("subchain_reach", _get_lib().atpu_subchain_reach, dev,
                nxt.data_ptr(), reach.data_ptr(), N, M, subm)
    return reach


def chain_marks(nxt: torch.Tensor, clen: torch.Tensor) -> torch.Tensor:
    """nxt (N, C) int32 (C a multiple of 128), clen (N,) int32 -> mark (N,
    C) bool: the positions below clen that the chain p -> nxt[p] from 0
    (none when clen <= 0) visits, threaded through the segments in order as
    ops/lz4_device._chain_marks_plain defines it."""
    N, C = nxt.shape
    dev = nxt.device
    if C % SEG:
        raise ValueError(f"chain_marks takes C a multiple of {SEG}, got {C}")
    _check("nxt", nxt, (N, C), dev)
    _check("clen", clen, (N,), dev)
    if nxt.data_ptr() % 16:    # the kernel reads 16 bytes a load
        nxt = nxt.clone()
    mark = torch.empty((N, C), dtype=torch.bool, device=dev)
    if N and C:
        _launch("chain_marks", _get_lib().atpu_chain_marks, dev,
                nxt.data_ptr(), clen.data_ptr(), mark.data_ptr(), N, C)
    return mark
