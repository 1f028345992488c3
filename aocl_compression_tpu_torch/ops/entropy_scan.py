"""Wrappers of the encoders' entropy-table scan kernels
(csrc/entropy_scan.cu).

Two hand kernels for sm_90a, one warp per row (codec block), built with
nvcc into _build/ at first use and bound with ctypes, as ops/zstd_scan.py
builds zstd_scan.cu:

  kraft_absorb        — the Kraft-deficit absorb over each row's
                        frequency-sorted code lengths, walked by runs of
                        equal length
                        (ops/deflate_device._kraft_absorb: zlib level 2's
                        _kraft_lengths at 288 and 32 symbols, MAXLEN 15;
                        zstd's _block_huffman at 256 symbols, MAXLEN 11);
  weights_fse_encode  — the two-state FSE encode of each row's 255 Huffman
                        weights with the static weight table, the two
                        states on two lanes, packed into the row's 512
                        output bytes afterwards
                        (ops/zstd_device._encode_weights).

Each wrapper takes CUDA tensors only, allocates its outputs with
torch.empty, launches on the current stream and raises when the launch
fails. weights_fse_encode first proves its table closed (table_closed),
once per table, and raises on one that is not: the kernel's state chain
carries no clamp. Their plain PyTorch versions live beside their callers,
which pick the kernel for a CUDA tensor and the plain loop for a CPU
tensor.
"""

from __future__ import annotations

import ctypes
import os
import threading
import weakref

import numpy as np
import torch

from . import compact

_SRC = os.path.join(compact._PKG, "csrc", "entropy_scan.cu")
_LIB = os.path.join(compact._BUILD, "libatpu_entropy_scan.so")

WCAP = 512      # output bytes of a weight row
WNUM = 255      # weights a row
WSTATES = 64    # states of the weight table (1 << WEIGHT_LOG)
WMAXBITS = 9    # widest field the plain version's two-byte scatter holds

_lib = None
_lock = threading.Lock()

#: kernel launches since the last reset, one per wrapper call (bumped
#: under _lock: the multi-device tier's shards launch from several threads)
launches = {"kraft_absorb": 0, "weights_fse_encode": 0}

#: nvcc's output of the last build in this process (ptxas resource usage)
build_log = ""

#: weight tables proven closed: (id nxt, id dnb, id dfs) -> (weak
#: references to the three tensors, their version counters)
_closed = {}


def build() -> str:
    """Compile csrc/entropy_scan.cu into _build/ (if stale) and return the
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
            for name, nptr, nint in (("atpu_kraft_absorb", 4, 3),
                                     ("atpu_weights_fse_encode", 6, 2)):
                fn = getattr(lib, name)
                fn.restype = i
                fn.argtypes = [p] * nptr + [i] * nint + [p]
            _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"{name} must be a CUDA tensor on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 4:
        raise ValueError(f"{name} must be contiguous and 4-byte aligned")


def _launch(kernel: str, fn, *args) -> None:
    err = fn(*args)
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    with _lock:
        launches[kernel] += 1


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def kraft_absorb(nbs, d0, MAXLEN: int):
    """nbs (N, NSYM) int32 code lengths in [0, MAXLEN], in any order (the
    callers sort them, which keeps the runs few); d0 (N,) int32 Kraft
    deficits -> (nbs2 (N, NSYM), D (N,)), both int32: the lengths after the
    absorb and the deficit left. NSYM up to 3,778 (a warp's 48 KB of shared
    memory)."""
    N, NSYM = nbs.shape
    dev = nbs.device
    if not 1 <= MAXLEN <= 30 or NSYM < 1:
        raise ValueError("kraft_absorb takes 1 <= MAXLEN <= 30 and NSYM >= 1")
    _check("nbs", nbs, torch.int32, (N, NSYM), dev)
    _check("d0", d0, torch.int32, (N,), dev)
    nbs2 = torch.empty_like(nbs)
    dout = torch.empty_like(d0)
    if N:
        lib = _get_lib()
        with torch.cuda.device(dev):
            _launch("kraft_absorb", lib.atpu_kraft_absorb, nbs.data_ptr(),
                    d0.data_ptr(), nbs2.data_ptr(), dout.data_ptr(), N, NSYM,
                    MAXLEN, _stream(dev))
    return nbs2, dout


def table_closed(nxt, dnb, dfs) -> bool:
    """Whether an FSE encode table (nxt (64,), dnb / dfs (NSYM,), numpy or
    CPU tensors) is closed: nxt in [64, 127], and for every state in [64,
    127] and symbol the width (st + dnb) >> 16 in [0, 9] and the next
    index (st >> width) + dfs in [0, 63], and every symbol's init index in
    [0, 63]. On a closed table the state never leaves [64, 127], so
    weights_fse_encode's chain needs no clamp, and every field fits the
    plain version's two-byte scatter."""
    nxt, dnb, dfs = (np.asarray(t, np.int64).reshape(-1)
                     for t in (nxt, dnb, dfs))
    if len(nxt) != WSTATES or not ((nxt >= 64) & (nxt < 128)).all():
        return False
    st = np.arange(WSTATES, 2 * WSTATES)[None, :]
    width = (st + dnb[:, None]) >> 16
    if not ((width >= 0) & (width <= WMAXBITS)).all():
        return False
    idx = (st >> width) + dfs[:, None]
    nbout = (dnb + (1 << 15)) >> 16
    if not ((nbout >= 0) & (nbout < 32)).all():
        return False
    init = (((nbout << 16) - dnb) >> nbout) + dfs
    return bool(((idx >= 0) & (idx < WSTATES)).all()
                and ((init >= 0) & (init < WSTATES)).all())


def _prove_closed(nxt, dnb, dfs) -> None:
    """Raise unless the table is closed; checked once per table (tensor
    objects and their version counters), on a host copy."""
    ts = (nxt, dnb, dfs)
    key = tuple(id(t) for t in ts)
    ver = tuple(t._version for t in ts)
    with _lock:
        hit = _closed.get(key)
    if hit and hit[1] == ver and all(r() is t for r, t in zip(hit[0], ts)):
        return
    if not table_closed(*(t.detach().cpu() for t in ts)):
        raise ValueError("weights_fse_encode: the FSE table is not closed "
                         "(a state index or next state leaves the table)")
    with _lock:
        _closed[key] = (tuple(weakref.ref(t) for t in ts), ver)


def weights_fse_encode(weights, nxt, dnb, dfs):
    """weights (N, 255) int32 in [0, NSYM); the static table: nxt (64,),
    dnb / dfs (NSYM,) int32, NSYM <= 16, closed (table_closed) -> (buf (N,
    512) uint8, size (N,) int32): each row's FSE-coded weight description
    and its byte count."""
    N = weights.shape[0]
    NSYM = dnb.shape[0]
    dev = weights.device
    if not 1 <= NSYM <= 16:
        raise ValueError("weights_fse_encode takes a table of 1-16 symbols")
    if nxt.shape != (WSTATES,) or dfs.shape != (NSYM,):
        raise ValueError("weights_fse_encode takes nxt (64,) and dnb, dfs "
                         "of one shape")
    _prove_closed(nxt, dnb, dfs)
    _check("weights", weights, torch.int32, (N, WNUM), dev)
    _check("nxt", nxt, torch.int32, (64,), dev)
    _check("dnb", dnb, torch.int32, (NSYM,), dev)
    _check("dfs", dfs, torch.int32, (NSYM,), dev)
    buf = torch.empty((N, WCAP), dtype=torch.uint8, device=dev)
    size = torch.empty((N,), dtype=torch.int32, device=dev)
    if N:
        lib = _get_lib()
        with torch.cuda.device(dev):
            _launch("weights_fse_encode", lib.atpu_weights_fse_encode,
                    weights.data_ptr(), nxt.data_ptr(), dnb.data_ptr(),
                    dfs.data_ptr(), buf.data_ptr(), size.data_ptr(), N, NSYM,
                    _stream(dev))
    return buf, size
