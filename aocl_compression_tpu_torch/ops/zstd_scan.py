"""Wrappers of the zstd tiers' serial-scan kernels (csrc/zstd_scan.cu).

Three hand kernels for sm_90a, one CUDA block per zstd block with the
block's tables in shared memory, built with nvcc into _build/ at first use
and bound with ctypes, as ops/compact.py builds compact.cu:

  fse_encode_scan    — the encoder's 3-state reverse FSE scan
                       (ops/zstd_device._fse_scan): three threads run the
                       ll, ml and of state chains in step while the block's
                       other warps stage their table pairs a chunk ahead in
                       shared memory and write the rows a chunk behind;
  huf_literal_scan   — the decoder's Huffman literal scan, one lane per
                       stream and one warp per lane
                       (ops/zstd_decode_device._literal_scan);
  fse_sequence_scan  — the decoder's FSE sequence scan, one lane per block
                       (ops/zstd_decode_device._sequence_scan).

The two decoders read their streams through a register bit buffer fed by
a cp.async ring in shared memory, so no global load sits on a step.

Each wrapper takes CUDA tensors only, allocates its outputs with
torch.empty, launches on the current stream and raises when the launch
fails. Their plain PyTorch versions live beside their callers, which pick
the kernel for a CUDA tensor and the plain loop for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import compact

_SRC = os.path.join(compact._PKG, "csrc", "zstd_scan.cu")
_LIB = os.path.join(compact._BUILD, "libatpu_zstd_scan.so")

_lib = None
_lock = threading.Lock()

#: kernel launches since the last reset, one per wrapper call (bumped
#: under _lock: the multi-device tier's shards launch from several threads)
launches = {"fse_encode_scan": 0, "huf_literal_scan": 0,
            "fse_sequence_scan": 0}

#: nvcc's output of the last build in this process (ptxas resource usage)
build_log = ""


def build() -> str:
    """Compile csrc/zstd_scan.cu into _build/ (if stale) and return the
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
            for name, nptr, nint in (("atpu_fse_encode_scan", 8, 2),
                                     ("atpu_huf_literal_scan", 6, 3),
                                     ("atpu_fse_sequence_scan", 8, 3)):
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


def fse_encode_scan(xs, nseq, nxt, dnb, dfs):
    """xs (N, MAXSEQ, 8) int32 [llc, llx, llb, mlc, mlx, mlb, ofc, ofx],
    nseq (N,), nxt (N, 3, 512), dnb / dfs (N, 3, 64) for [ll, ml, of] ->
    (pv, pn) (N, MAXSEQ, 6) in processing order and the final [ll, ml, of]
    states (N, 3), all int32."""
    N, MAXSEQ, _ = xs.shape
    dev = xs.device
    i32 = torch.int32
    for name, t, shape in (("xs", xs, (N, MAXSEQ, 8)), ("nseq", nseq, (N,)),
                           ("nxt", nxt, (N, 3, 512)), ("dnb", dnb, (N, 3, 64)),
                           ("dfs", dfs, (N, 3, 64))):
        _check(name, t, i32, shape, dev)
    pv = torch.empty((N, MAXSEQ, 6), dtype=i32, device=dev)
    pn = torch.empty_like(pv)
    fin = torch.empty((N, 3), dtype=i32, device=dev)
    lib = _get_lib()
    with torch.cuda.device(dev):
        _launch("fse_encode_scan", lib.atpu_fse_encode_scan, xs.data_ptr(),
                nseq.data_ptr(), nxt.data_ptr(), dnb.data_ptr(),
                dfs.data_ptr(), pv.data_ptr(), pn.data_ptr(), fin.data_ptr(),
                N, MAXSEQ, _stream(dev))
    return pv, pn, fin


def huf_literal_scan(sbytes, slens, counts, huftab, huflog, MAXL: int):
    """sbytes (4N, SB) uint8 (SB % 4 == 0), slens / counts / huflog (4N,)
    int32, huftab (N, 2048) int32 -> syms (4N, MAXL) uint8: every slot
    below min(counts, MAXL) decoded; the slots past it are not written."""
    L, SB = sbytes.shape
    N = L // 4
    dev = sbytes.device
    if L % 4 or SB % 4:
        raise ValueError("huf_literal_scan takes 4 lanes per block and "
                         "4-byte stream rows")
    _check("sbytes", sbytes, torch.uint8, (L, SB), dev)
    for name, t in (("slens", slens), ("counts", counts),
                    ("huflog", huflog)):
        _check(name, t, torch.int32, (L,), dev)
    _check("huftab", huftab, torch.int32, (N, 2048), dev)
    syms = torch.empty((L, MAXL), dtype=torch.uint8, device=dev)
    lib = _get_lib()
    with torch.cuda.device(dev):
        _launch("huf_literal_scan", lib.atpu_huf_literal_scan,
                sbytes.data_ptr(), slens.data_ptr(), counts.data_ptr(),
                huftab.data_ptr(), huflog.data_ptr(), syms.data_ptr(), N, SB,
                MAXL, _stream(dev))
    return syms


def fse_sequence_scan(qbytes, qlens, nbseq, fsetab, logs, MAXSEQ: int):
    """qbytes (N, QB) uint8 (QB % 4 == 0), qlens / nbseq (N,) int32, fsetab
    (N, 3, 512) int32 and logs (N, 3) int32 for [ll, of, ml] -> (ll, ml,
    off), each (N, MAXSEQ) int32, (0, 0, 1) past nbseq."""
    N, QB = qbytes.shape
    dev = qbytes.device
    if QB % 4:
        raise ValueError("fse_sequence_scan takes 4-byte section rows")
    _check("qbytes", qbytes, torch.uint8, (N, QB), dev)
    for name, t, shape in (("qlens", qlens, (N,)), ("nbseq", nbseq, (N,)),
                           ("fsetab", fsetab, (N, 3, 512)),
                           ("logs", logs, (N, 3))):
        _check(name, t, torch.int32, shape, dev)
    ll = torch.empty((N, MAXSEQ), dtype=torch.int32, device=dev)
    ml = torch.empty_like(ll)
    off = torch.empty_like(ll)
    lib = _get_lib()
    with torch.cuda.device(dev):
        _launch("fse_sequence_scan", lib.atpu_fse_sequence_scan,
                qbytes.data_ptr(), qlens.data_ptr(), nbseq.data_ptr(),
                fsetab.data_ptr(), logs.data_ptr(), ll.data_ptr(),
                ml.data_ptr(), off.data_ptr(), N, QB, MAXSEQ, _stream(dev))
    return ll, ml, off
