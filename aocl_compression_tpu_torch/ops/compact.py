"""Device-side stream compaction — pack variable-sized compressed chunks
from the encoders' padded (N, OUTCAP) output into one dense buffer on the
device, so the host fetches ~compressed bytes instead of the padded
capacity.

CUDA path: the hand-written kernels of csrc/compact.cu (the port of the
JAX package's ops/compact.py::_pallas_compact), two launches with no host
sync and no other device op between the encoder and the fetch: a
one-block layout scan over the encoder's raw sizes, then a balanced copy
of the dense output in 16 KB slabs by 1-D bulk async copies. They are
built with nvcc for sm_90a into _build/ at first use and bound with
ctypes.

Plain path: the same function in PyTorch ops (the layout, and the JAX
package's _xla_compact for the copy). It runs for tensors on the CPU, and
is what the kernels are held against on the card.

Both return (dense, meta): dense is (N*ROWS, 128) int32 with every chunk
at its row offset in dense[:used]; meta is int32 [used, row_offs[0..N),
sz[0..N)], with sz = clamp(sizes, 0, OUTCAP) and row_offs the exclusive
cumsum of ceil(sz/512). Chunks start row-aligned; the host slices exact
byte ranges out of the fetched rows (row padding never crosses into
another chunk's bytes).
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

#: kernel launches since the last reset (two per compact_rows on CUDA:
#: the layout scan and the copy); bumped under _lock, since the shards of
#: the multi-device tier launch from several threads
launches = 0

#: nvcc's output of the last build in this process (ptxas resource usage)
build_log = ""


def round_capacity(n: int) -> int:
    """Round an encoder OUTCAP up to the row quantum."""
    return -(-n // ROWB) * ROWB


def nvcc_build(src: str, lib: str) -> str:
    """Compile the CUDA source `src` for sm_90a into the shared library
    `lib` (if it is missing or older than the source) with ptxas's resource
    report; returns nvcc's output ("" when the library is up to date).
    Raises if nvcc fails."""
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return ""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    res = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                          "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                          "-Xcompiler", "-fPIC", "-o", tmp, src],
                         capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    os.replace(tmp, lib)
    return log


def build() -> str:
    """Compile csrc/compact.cu into _build/ (if stale) and return the
    library path. Raises if nvcc fails."""
    global build_log
    log = nvcc_build(_SRC, _LIB)
    if log:
        build_log = log
    return _LIB


def bind(path: str) -> ctypes.CDLL:
    """Load a build of csrc/compact.cu and declare its C interface."""
    lib = ctypes.CDLL(path)
    lib.atpu_compact_meta_len.restype = ctypes.c_longlong
    lib.atpu_compact_meta_len.argtypes = [ctypes.c_int] * 2
    lib.atpu_compact_layout.restype = ctypes.c_int
    lib.atpu_compact_layout.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.atpu_compact_copy.restype = ctypes.c_int
    lib.atpu_compact_copy.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
    return _lib


def _rows_view(bodies_u8: torch.Tensor) -> torch.Tensor:
    N, OUTCAP = bodies_u8.shape
    if OUTCAP % ROWB:
        raise ValueError("encoder OUTCAP must be 512-byte aligned")
    if bodies_u8.stride() != (OUTCAP, 1):
        # dense rows; contiguous() would keep a (1, OUTCAP) slice of a
        # wider buffer as it is (a size-1 dimension's stride is ignored)
        bodies_u8 = bodies_u8.clone(memory_format=torch.contiguous_format)
    return bodies_u8.view(torch.int32).reshape(N, OUTCAP // ROWB, ROWW)


def compact_rows_plain(bodies: torch.Tensor, sizes: torch.Tensor):
    """PyTorch version of the whole function: (dense, meta) as in the
    module docstring. Rows of dense past `used` hold row 0 (the JAX
    package's _xla_compact)."""
    N, OUTCAP = bodies.shape
    rows = _rows_view(bodies)
    ROWS = rows.shape[1]
    total = N * ROWS
    dev = rows.device
    # a flagged block's body may exceed the padded capacity; clamping keeps
    # every copy inside its chunk (the caller replaces such bodies)
    sz = torch.clamp(sizes.to(torch.int32), 0, OUTCAP)
    rowcnt = (sz + (ROWB - 1)) // ROWB
    incl = torch.cumsum(rowcnt, 0, dtype=torch.int32)
    row_offs = incl - rowcnt
    used = incl[-1:]
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
    return rows.reshape(total, ROWW)[src], torch.cat([used, row_offs, sz])


def compact_rows_kernel(bodies: torch.Tensor, sizes: torch.Tensor):
    """Launch csrc/compact.cu's layout and copy kernels on the current
    stream: (dense, meta) as in the module docstring; rows of dense past
    `used` are left unwritten. `sizes` is read in place (any stride)."""
    global launches
    N, OUTCAP = bodies.shape
    rows = _rows_view(bodies)
    ROWS = rows.shape[1]
    if not (rows.is_cuda and sizes.is_cuda and sizes.device == rows.device):
        raise ValueError("compact_rows_kernel takes CUDA tensors on one "
                         "device")
    if sizes.dtype != torch.int32 or sizes.shape != (N,):
        raise ValueError("sizes must be (N,) int32")
    if rows.data_ptr() % 16:
        raise ValueError("bodies must be 16-byte aligned for bulk copies")
    if N * ROWS >= 2 ** 31:
        raise ValueError("compact_rows: more than 2^31 - 1 rows")
    dev = rows.device
    lib = _get_lib()
    # meta, then the slab owners the copy kernel reads
    meta = torch.empty(lib.atpu_compact_meta_len(N, ROWS), dtype=torch.int32,
                       device=dev)
    dense = torch.empty((N * ROWS, ROWW), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.atpu_compact_layout(sizes.data_ptr(), sizes.stride(0),
                                      meta.data_ptr(), N, OUTCAP, stream)
        if err:
            raise RuntimeError(f"compact layout kernel launch failed: CUDA "
                               f"error {err}")
        with _lock:
            launches += 1
        err = lib.atpu_compact_copy(rows.data_ptr(), meta.data_ptr(),
                                    dense.data_ptr(), N, ROWS, stream)
        if err:
            raise RuntimeError(f"compact copy kernel launch failed: CUDA "
                               f"error {err}")
        with _lock:
            launches += 1
    return dense, meta[:2 * N + 1]


def _compact(bodies: torch.Tensor, sizes: torch.Tensor):
    """(dense, meta) on the bodies' device: a CUDA tensor runs the kernels,
    a CPU tensor the plain version."""
    if bodies.is_cuda:
        return compact_rows_kernel(bodies, sizes)
    if bodies.device.type == "cpu":
        return compact_rows_plain(bodies, sizes)
    raise ValueError(f"compact_rows: unsupported device {bodies.device}")


def compact_rows(bodies: torch.Tensor, sizes: torch.Tensor):
    """Compact on the bodies' device: returns (dense (N*ROWS, 128) int32,
    row_offs (N,) int32, used (1,) int32, clamped sizes (N,) int32).
    dense[:used] holds every chunk at its row offset."""
    N = bodies.shape[0]
    dense, meta = _compact(bodies, sizes)
    return dense, meta[1:N + 1], meta[:1], meta[N + 1:]


def _no_mark(stage: str) -> None:
    pass


def fetch_chunks(bodies: torch.Tensor, sizes: torch.Tensor,
                 mark=_no_mark) -> List[bytes]:
    """Compact on the device, fetch once, slice per-chunk byte strings.

    Routed through the dispatch registry so the compactor is an auditable
    tier: KERNEL (the JAX package's fetch_chunks_pallas) runs the kernels
    on a CUDA tensor; TORCH (its fetch_chunks_xla) runs the plain version
    on any device, so a TORCH cap launches no compaction kernel. mark is
    _fetch_impl's stage hook."""
    from ..utils import dispatch
    fn = dispatch.resolve("container", "fetch_chunks", None)
    return fn(bodies, sizes, mark=mark)


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    """Start a copy of a CUDA tensor into pinned host memory (PyTorch's
    caching host allocator reuses the block); the caller synchronises."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t, non_blocking=True)


def _fetch_impl(bodies: torch.Tensor, sizes: torch.Tensor,
                mark=_no_mark, compact=_compact) -> List[bytes]:
    """Compact with `compact` (_compact: the kernels on a CUDA tensor; or
    compact_rows_plain), copy meta and then dense[:used] into pinned host
    memory (one stream sync each), and slice each chunk's bytes from the
    pinned rows. On a CUDA tensor, mark(stage) is called on the host at the
    stage boundaries: after the compaction and the meta copy are enqueued
    ("compaction", "meta_d2h"), once meta is on the host and the rows'
    pinned buffer is allocated ("d2h_start"), and after the rows' copy is
    enqueued ("d2h"); chip_smoke.py records a CUDA event at each to time
    the stages of this very fetch."""
    N = bodies.shape[0]
    dense, meta = compact(bodies, sizes)
    if dense.is_cuda:
        stream = torch.cuda.current_stream(dense.device)
        mark("compaction")
        meta = _to_pinned(meta)
        mark("meta_d2h")
        stream.synchronize()
        used = int(meta[0])
        rows = torch.empty((used, ROWW), dtype=dense.dtype, pin_memory=True)
        mark("d2h_start")
        dense = rows.copy_(dense[:used], non_blocking=True)
        mark("d2h")
        stream.synchronize()
    m = meta.tolist()
    used, offs, sz = m[0], m[1:N + 1], m[N + 1:]
    buf = memoryview(dense[:used].reshape(-1).view(torch.uint8).numpy())
    return [buf[o * ROWB: o * ROWB + s].tobytes() for o, s in zip(offs, sz)]


def _fetch_plain(bodies: torch.Tensor, sizes: torch.Tensor,
                 mark=_no_mark) -> List[bytes]:
    """_fetch_impl with the plain compaction on any device (the JAX
    package's fetch_chunks_xla → _xla_compact)."""
    return _fetch_impl(bodies, sizes, mark, compact=compact_rows_plain)


def _register_tiers():
    from ..utils import dispatch
    from ..utils.config import TIER_KERNEL, TIER_TORCH
    dispatch.register("container", "fetch_chunks", TIER_KERNEL,
                      "fetch_chunks_kernel")(_fetch_impl)
    dispatch.register("container", "fetch_chunks", TIER_TORCH,
                      "fetch_chunks_torch")(_fetch_plain)


_register_tiers()
