"""Device-side stream compaction — pack variable-sized compressed chunks
from the encoders' padded (N, OUTCAP) output into one dense buffer on the
device, so the host fetches ~compressed bytes instead of the padded
capacity.

CUDA path: the hand-written kernel csrc/compact.cu (one thread block per
chunk copies only its own rows; the port of the JAX package's
ops/compact.py::_pallas_compact). It is built with nvcc for sm_90a into
_build/ at first use and bound with ctypes.

Plain path: the same layout in PyTorch ops (the JAX package's
_xla_compact). It runs for tensors on the CPU, and is what the kernel is
held against on the card.

Row quantum: 512 bytes. Chunks start row-aligned in the dense buffer at
the exclusive cumsum of ceil(size/512); the host slices exact byte ranges
out of the fetched buffer (row padding never crosses into another
chunk's bytes).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List

import torch

ROWW = 128                 # int32 lanes per row
ROWB = ROWW * 4            # bytes per row quantum

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "compact.cu")
_BUILD = os.path.join(_PKG, "_build")
_LIB = os.path.join(_BUILD, "libatpu_compact.so")

_lib = None
_lock = threading.Lock()

#: kernel launches since the last reset (one per compact_rows on CUDA)
launches = 0


def round_capacity(n: int) -> int:
    """Round an encoder OUTCAP up to the row quantum."""
    return -(-n // ROWB) * ROWB


def build() -> str:
    """Compile csrc/compact.cu for sm_90a into _build/ (if stale) and
    return the library path. Raises if nvcc fails."""
    if (os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", tmp, _SRC], check=True)
    os.replace(tmp, _LIB)
    return _LIB


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.atpu_compact_rows
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
                ctypes.c_void_p]
            _lib = lib
    return _lib


def _rows_view(bodies_u8: torch.Tensor) -> torch.Tensor:
    N, OUTCAP = bodies_u8.shape
    if OUTCAP % ROWB:
        raise ValueError("encoder OUTCAP must be 512-byte aligned")
    return bodies_u8.contiguous().view(torch.int32).reshape(
        N, OUTCAP // ROWB, ROWW)


def _layout(sizes: torch.Tensor, OUTCAP: int):
    """(clamped sizes, exclusive row offsets, used rows as a 1-element
    tensor), all int32 on the sizes' device. A flagged block's body may
    exceed the padded capacity; clamping keeps every copy inside its chunk
    (the caller replaces such bodies)."""
    sz = torch.clamp(sizes.to(torch.int32), 0, OUTCAP)
    rowcnt = (sz + (ROWB - 1)) // ROWB
    incl = torch.cumsum(rowcnt, 0, dtype=torch.int32)
    return sz, incl - rowcnt, incl[-1:]


def compact_rows_plain(rows: torch.Tensor, row_offs: torch.Tensor,
                       used: torch.Tensor) -> torch.Tensor:
    """PyTorch version: dense[r] = the row that lands at r, for r < used
    (the JAX package's _xla_compact; rows past `used` hold row 0)."""
    N, ROWS, _ = rows.shape
    total = N * ROWS
    dev = rows.device
    r = torch.arange(total, dtype=torch.int64, device=dev)
    offs = row_offs.to(torch.int64)
    # owner of each dense row: the last chunk starting at or before it
    # (chunks with no rows share their offset with the next chunk)
    t = torch.zeros(total, dtype=torch.int64, device=dev)
    t.scatter_reduce_(0, torch.clamp(offs, max=total - 1),
                      torch.where(offs < total,
                                  torch.arange(N, device=dev), 0),
                      reduce="amax")
    c = torch.cummax(t, 0).values
    src = c * ROWS + (r - offs[c])
    src = torch.where(r < used.to(torch.int64), torch.clamp(src, 0, total - 1),
                      0)
    return rows.reshape(total, ROWW)[src]


def compact_rows_kernel(rows: torch.Tensor, row_offs: torch.Tensor,
                        sizes: torch.Tensor) -> torch.Tensor:
    """Launch csrc/compact.cu on the current stream. Rows of `dense` past
    the used count are left unwritten."""
    global launches
    N, ROWS, _ = rows.shape
    for t, dt in ((rows, torch.int32), (row_offs, torch.int32),
                  (sizes, torch.int32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError("compact_rows_kernel takes contiguous int32 "
                             "CUDA tensors")
    if row_offs.shape != (N,) or sizes.shape != (N,):
        raise ValueError("row_offs and sizes must be (N,)")
    dense = torch.empty((N * ROWS, ROWW), dtype=torch.int32,
                        device=rows.device)
    err = _get_lib().atpu_compact_rows(
        rows.data_ptr(), row_offs.data_ptr(), sizes.data_ptr(),
        dense.data_ptr(), N, ROWS, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"compact_rows kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return dense


def compact_rows(bodies: torch.Tensor, sizes: torch.Tensor):
    """Compact on the bodies' device: returns (dense (N*ROWS, 128) int32,
    row_offs (N,) int32, used (1,) int32, clamped sizes (N,) int32).
    dense[:used] holds every chunk at its row offset. A CUDA tensor runs
    the kernel; a CPU tensor runs the plain version."""
    N, OUTCAP = bodies.shape
    rows = _rows_view(bodies)
    sz, row_offs, used = _layout(sizes, OUTCAP)
    if bodies.is_cuda:
        dense = compact_rows_kernel(rows, row_offs, sz)
    elif bodies.device.type == "cpu":
        dense = compact_rows_plain(rows, row_offs, used)
    else:
        raise ValueError(f"compact_rows: unsupported device {bodies.device}")
    return dense, row_offs, used, sz


def fetch_chunks(bodies: torch.Tensor, sizes: torch.Tensor) -> List[bytes]:
    """Compact on the device, fetch once, slice per-chunk byte strings.

    Routed through the dispatch registry so the compactor is an auditable
    tier (KERNEL mirrors the JAX package's fetch_chunks_pallas, TORCH its
    fetch_chunks_xla); both run the kernel on a CUDA tensor."""
    from ..utils import dispatch
    fn = dispatch.resolve("container", "fetch_chunks", None)
    return fn(bodies, sizes)


def _fetch_impl(bodies: torch.Tensor, sizes: torch.Tensor) -> List[bytes]:
    N = bodies.shape[0]
    dense, row_offs, used, sz = compact_rows(bodies, sizes)
    meta = torch.cat([used, row_offs, sz]).tolist()
    used_rows, offs, sz = meta[0], meta[1:N + 1], meta[N + 1:]
    buf = dense[:used_rows].cpu().numpy().tobytes()
    return [buf[offs[i] * ROWB: offs[i] * ROWB + sz[i]] for i in range(N)]


def _register_tiers():
    from ..utils import dispatch
    from ..utils.config import TIER_KERNEL, TIER_TORCH
    dispatch.register("container", "fetch_chunks", TIER_KERNEL,
                      "fetch_chunks_kernel")(_fetch_impl)
    dispatch.register("container", "fetch_chunks", TIER_TORCH,
                      "fetch_chunks_torch")(_fetch_impl)


_register_tiers()
