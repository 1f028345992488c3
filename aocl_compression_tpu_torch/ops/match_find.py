"""Wrappers of the match-finder kernels (csrc/match_find.cu).

Three hand kernels for sm_90a, built with nvcc into _build/ at first use
and bound with ctypes, as ops/chain_scan.py builds chain_scan.cu. In turn
they compute ops/lz4_device._find_matches, the first stage of every device
encoder:

  match_keys        each row's sort keys (hash << 16 | position) in
                    ascending order, as torch.sort of them gives: a stable
                    counting sort by the hash's digits in shared memory;
  match_candidates  the best of the `depth` previous same-hash positions of
                    each sorted entry, the windows held in registers and
                    handed between a warp's lanes, as (offset << 16 |
                    length) at each position;
  match_runs        the exact runs at the small offsets, the saturated-match
                    ladder and the end-of-block rules: (mlen, moff, valid),
                    a cluster of CTAs a row at small batches (runs_ctas).

Each wrapper takes CUDA tensors only, allocates its outputs with
torch.empty, launches on the current stream and raises when the launch
fails (there is no fallback). Their plain PyTorch versions
(_match_sorted_keys_plain, _match_candidates_plain, _match_runs_plain) live
beside their caller in ops/lz4_device.py, which picks the kernels for a
CUDA tensor and the plain versions for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import compact

_SRC = os.path.join(compact._PKG, "csrc", "match_find.cu")
_LIB = os.path.join(compact._BUILD, "libatpu_match_find.so")

MAX_OFFSETS = 8       # small offsets match_runs takes
MAX_BLOCK = 65536     # positions and offsets are packed into 16 bits
_lib = None
_lock = threading.Lock()

#: kernel launches since the last reset, one per wrapper call (bumped
#: under _lock: the multi-device tier's shards launch from several threads)
launches = {"match_keys": 0, "match_candidates": 0, "match_runs": 0}

#: nvcc's output of the last build in this process (ptxas resource usage)
build_log = ""


def build() -> str:
    """Compile csrc/match_find.cu into _build/ (if stale) and return the
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
            for name, args in (
                    ("atpu_match_keys", [p, p, i, i, i, p]),
                    ("atpu_match_candidates", [p, p, p] + [i] * 6 + [p]),
                    ("atpu_match_runs",
                     [p] * 6 + [i, i, ctypes.POINTER(i)] + [i] * 3 + [p]),
                    ("atpu_match_runs_ctas",
                     [i, i, ctypes.POINTER(i)] + [i] * 3)):
                fn = getattr(lib, name)
                fn.restype = i
                fn.argtypes = args
            _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"{name} must be a CUDA tensor on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _data(data_u8: torch.Tensor, B: int):
    if data_u8.dim() != 2 or not 1 <= B <= MAX_BLOCK:
        raise ValueError(f"the match finder takes (N, B) rows with 1 <= B <= "
                         f"{MAX_BLOCK}, got {tuple(data_u8.shape)}, B={B}")
    dev = data_u8.device
    _check("data_u8", data_u8, torch.uint8, (data_u8.shape[0], B), dev)
    return data_u8.shape[0], dev


def _launch(kernel: str, fn, dev, *args) -> None:
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    with _lock:
        launches[kernel] += 1


def match_keys(data_u8: torch.Tensor, B: int, hash_bits: int) -> torch.Tensor:
    """data_u8 (N, B) uint8 -> each row's keys (N, B) int32 in ascending
    order: the keys (h << 16 | p) with the uint32 -> int32 wrap, h the hash
    of the 4 bytes at p (zeros past B), bit for bit torch.sort(keys,
    dim=-1).values (so at hash_bits 16 the hashes >= 32,768 come first, and
    a hash's positions ascend)."""
    N, dev = _data(data_u8, B)
    if not 1 <= hash_bits <= 16:
        raise ValueError(f"match_keys takes 1 <= hash_bits <= 16, got "
                         f"{hash_bits}")
    key = torch.empty((N, B), dtype=torch.int32, device=dev)
    if N:
        _launch("match_keys", _get_lib().atpu_match_keys, dev,
                data_u8.data_ptr(), key.data_ptr(), N, B, hash_bits)
    return key


def match_candidates(data_u8: torch.Tensor, skey: torch.Tensor, B: int,
                     max_off: int, depth: int, nw: int,
                     nw_deep: int) -> torch.Tensor:
    """data_u8 (N, B) uint8 and each row's sorted keys skey (N, B) int32 ->
    best (N, B) int32, (offset << 16 | length) of each position's best
    same-hash candidate (1 << 16 where none)."""
    N, dev = _data(data_u8, B)
    _check("skey", skey, torch.int32, (N, B), dev)
    if min(depth, nw, nw_deep) < 0 or B + 4 * nw + 8 > 232448:
        raise ValueError(f"match_candidates takes depth, nw, nw_deep >= 0 "
                         f"and a staged row B + 4*nw + 8 <= 232,448 B, got "
                         f"depth={depth}, nw={nw}, nw_deep={nw_deep}")
    best = torch.empty((N, B), dtype=torch.int32, device=dev)
    if N:
        _launch("match_candidates", _get_lib().atpu_match_candidates, dev,
                data_u8.data_ptr(), skey.data_ptr(), best.data_ptr(), N, B,
                depth, nw, nw_deep, max_off)
    return best


def _runs_args(small_offsets: tuple, nw: int, ext_passes: int):
    offs = [int(o) for o in small_offsets]
    if len(offs) > MAX_OFFSETS or min(offs, default=1) < 1 or \
            ext_passes < 0 or nw < 0:
        raise ValueError(f"match_runs takes at most {MAX_OFFSETS} small "
                         f"offsets >= 1, ext_passes >= 0 and nw >= 0, got "
                         f"{small_offsets}, {ext_passes}, {nw}")
    return (ctypes.c_int * MAX_OFFSETS)(*offs), len(offs)


def match_runs(data_u8: torch.Tensor, best: torch.Tensor, n: torch.Tensor,
               B: int, small_offsets: tuple, nw: int, ext_passes: int):
    """data_u8 (N, B) uint8, best (N, B) int32 from match_candidates, n (N,)
    int32 block lengths -> (mlen, moff, valid), each (N, B)."""
    N, dev = _data(data_u8, B)
    _check("best", best, torch.int32, (N, B), dev)
    _check("n", n, torch.int32, (N,), dev)
    arr, noffs = _runs_args(small_offsets, nw, ext_passes)
    mlen = torch.empty((N, B), dtype=torch.int32, device=dev)
    moff = torch.empty((N, B), dtype=torch.int32, device=dev)
    valid = torch.empty((N, B), dtype=torch.bool, device=dev)
    if N:
        _launch("match_runs", _get_lib().atpu_match_runs, dev,
                data_u8.data_ptr(), best.data_ptr(), n.data_ptr(),
                mlen.data_ptr(), moff.data_ptr(), valid.data_ptr(), N, B,
                arr, noffs, ext_passes, nw)
    return mlen, moff, valid


def runs_ctas(N: int, B: int, small_offsets: tuple, nw: int,
              ext_passes: int, device=None) -> int:
    """The CTAs a row (one cluster) that match_runs launches for N rows of
    B on the CUDA device (the current one by default)."""
    arr, noffs = _runs_args(small_offsets, nw, ext_passes)
    with torch.cuda.device(device):
        k = _get_lib().atpu_match_runs_ctas(N, B, arr, noffs, ext_passes, nw)
    if k <= 0:
        raise RuntimeError(f"match_runs takes no N={N}, B={B}: CUDA error "
                           f"{-k}")
    return k
