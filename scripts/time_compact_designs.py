#!/usr/bin/env python3
"""Device time of the port's compaction (aocl_compression_tpu_torch/csrc/
compact.cu: layout scan + bulk slab copy) beside the earlier one-block-
per-chunk design, timed the same ways in one process on one card.

    python3 scripts/time_compact_designs.py --old DIR

DIR is an unpacked checkout of an earlier commit whose
aocl_compression_tpu_torch/csrc/compact.cu exports
atpu_compact_rows(src, row_offs, sizes, dst, n_chunks, rows_per_chunk,
stream): one block per chunk, with the layout (clamp, row counts, cumsum)
as aten ops before it. Its source is built with nvcc into DIR/_time_build
and bound with ctypes; the layout runs here as that commit's
ops/compact.py::_layout ran it, and the meta is joined with torch.cat as
its fetch did.

For each shape, both designs are checked equal on dense[:used] and meta,
then timed in the order old, new, new, old:
  - by CUDA-graph replay (device time without host launch gaps);
  - by eager back-to-back calls between two CUDA events (host launch
    cost included where it exceeds the device time).
The old design is timed whole (layout ops + kernel + cat) and as its
kernel alone on a precomputed layout. Shapes: the main path's (N=256
chunks of 64 KiB, sizes from a real encode of chip_smoke.py's corpus),
and N=16384 x 512, N=65536 x 512 and N=16384 x 65536 (1 GiB) with random
sizes up to 1.5 OUTCAP.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import corpus, cuda_ms, graph_ms  # noqa: E402


def build_old(old_root: str) -> ctypes.CDLL:
    from torch.utils.cpp_extension import CUDA_HOME
    src = os.path.join(old_root, "aocl_compression_tpu_torch", "csrc",
                       "compact.cu")
    out_dir = os.path.join(old_root, "_time_build")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libold_compact.so")
    subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib_path, src],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    lib.atpu_compact_rows.restype = ctypes.c_int
    lib.atpu_compact_rows.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib


def old_layout(sizes: torch.Tensor, outcap: int):
    sz = torch.clamp(sizes.to(torch.int32), 0, outcap)
    rowcnt = (sz + 511) // 512
    incl = torch.cumsum(rowcnt, 0, dtype=torch.int32)
    return sz, incl - rowcnt, incl[-1:]


def old_kernel(lib, rows, row_offs, sz):
    n, rows_per_chunk, roww = rows.shape
    dense = torch.empty((n * rows_per_chunk, roww), dtype=torch.int32,
                        device=rows.device)
    err = lib.atpu_compact_rows(rows.data_ptr(), row_offs.data_ptr(),
                                sz.data_ptr(), dense.data_ptr(), n,
                                rows_per_chunk,
                                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old compact kernel launch failed: {err}")
    return dense


def old_full(lib, compact, bodies, sizes):
    rows = compact._rows_view(bodies)
    sz, row_offs, used = old_layout(sizes, bodies.shape[1])
    dense = old_kernel(lib, rows, row_offs, sz)
    return dense, torch.cat([used, row_offs, sz])


def time_shape(lib, compact, label, bodies, sizes):
    rows = compact._rows_view(bodies)
    sz, row_offs, _ = old_layout(sizes, bodies.shape[1])
    od, ometa = old_full(lib, compact, bodies, sizes)
    nd, nmeta = compact.compact_rows_kernel(bodies, sizes)
    torch.cuda.synchronize()
    u = int(nmeta[0])
    if not (torch.equal(ometa, nmeta) and torch.equal(od[:u], nd[:u])):
        raise AssertionError(f"old and new compaction differ ({label})")
    fns = {
        "old_full": lambda: old_full(lib, compact, bodies, sizes),
        "old_kernel": lambda: old_kernel(lib, rows, row_offs, sz),
        "new": lambda: compact.compact_rows_kernel(bodies, sizes),
    }
    res = {k: {"graph_ms": [], "eager_ms": []} for k in fns}
    for order in (("old_full", "old_kernel", "new"),
                  ("new", "old_kernel", "old_full")):
        for k in order:
            res[k]["graph_ms"].append(graph_ms(fns[k]))
            res[k]["eager_ms"].append(cuda_ms(fns[k], 200))
    row = {"shape": label, "N": bodies.shape[0], "OUTCAP": bodies.shape[1],
           "used_rows": u, **res}
    print(json.dumps(row))
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="unpacked checkout of the earlier commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_compact_designs: no CUDA device", file=sys.stderr)
        return 1
    from aocl_compression_tpu_torch.ops import compact, lz4_device

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    lib = build_old(args.old)
    compact.build()
    dev = torch.device("cuda")

    B, N = 65536, 256
    data = corpus(B * N)
    arr = torch.from_numpy(
        np.frombuffer(data, dtype=np.uint8).reshape(N, B).copy()).to(dev)
    lens = torch.full((N,), B, dtype=torch.int32, device=dev)
    out, sizes, _, _ = lz4_device.make_encoder(B, 4)(arr, lens)
    time_shape(lib, compact, "main path encode", out, sizes)
    del arr, out

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rng = np.random.default_rng(7)
    for n, outcap in ((16384, 512), (65536, 512), (16384, 65536)):
        bodies = torch.randint(0, 256, (n, outcap), dtype=torch.uint8,
                               device=dev, generator=gen)
        sz = torch.from_numpy(rng.integers(0, outcap * 3 // 2 + 1, n)
                              .astype(np.int32)).to(dev)
        time_shape(lib, compact, f"random sizes {n}x{outcap}", bodies, sz)
        del bodies
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
