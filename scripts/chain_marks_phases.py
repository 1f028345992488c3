#!/usr/bin/env python3
"""Where chain_marks (aocl_compression_tpu_torch/csrc/chain_scan.cu) spends
its time: SM cycles per CUDA block in each of its phases, on the real
inputs of scripts/time_chain_kernels.py.

    python3 scripts/chain_marks_phases.py

It copies chain_scan.cu into _time_build/phases/ with a clock64() stamp
after each __syncthreads() of chain_marks_kernel (thread 0 adds the cycles
since the previous stamp to a device counter of that stamp), builds the
copy with nvcc, runs it once on each chain_marks input and prints the
cycles per CTA of each stamp (summed over the CTAs and their windows,
divided by the CTAs launched: K a row in a cluster of K): 1 the start
(clen, the chain's first position, the cluster's first barrier), 2 the
staging of the targets, 3 the per-segment sweep into the exit table, 4
the chain threaded through the segments by one thread (in a cluster's
later CTAs with the guessed chain and the wait for the true entry), 5 the
walks that mark each entered segment, 6 the write of the marks. The
stamps add a few cycles each; the kernel's time comes from
time_chain_kernels.py, not from here.
"""

import ctypes
import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import time_chain_kernels as tk  # noqa: E402
from aocl_compression_tpu_torch.ops import compact  # noqa: E402

_KERNEL = "chain_marks_kernel(const int32_t* __restrict__ nxt,"


def instrumented() -> str:
    """chain_scan.cu with the stamps and an entry point that reads or
    clears their counters; returns the path of its build."""
    src = open(os.path.join(ROOT, "aocl_compression_tpu_torch", "csrc",
                            "chain_scan.cu")).read()
    head, body = src.split(_KERNEL, 1)
    kern, tail = body.split("}  // namespace", 1)
    n = [0]

    def stamp(_):
        n[0] += 1
        return (f"__syncthreads(); if (tid == 0) {{ long long now = "
                f"clock64(); atomicAdd(&g_stamp[{n[0]}], (unsigned long "
                f"long)(now - last)); last = now; }}")

    kern = re.sub(r"__syncthreads\(\);", stamp, kern)
    kern = kern.replace("  const int len = clen[row];",
                        "  long long last = clock64();\n"
                        "  if (threadIdx.x == 0) "
                        "atomicAdd(&g_stamp[0], 1ull);\n"
                        "  const int len = clen[row];", 1)
    code = (head.replace("namespace {", "__device__ unsigned long long "
                         "g_stamp[16];\nnamespace {", 1)
            + _KERNEL + kern + "}  // namespace" + tail
            + '\nextern "C" int atpu_chain_stamps(void* out, int clear) {\n'
              '  if (clear) {\n'
              '    unsigned long long z[16] = {};\n'
              '    return (int)cudaMemcpyToSymbol(g_stamp, z, sizeof(z));\n'
              '  }\n'
              '  return (int)cudaMemcpyFromSymbol(out, g_stamp,\n'
              '                                   sizeof(g_stamp));\n'
              '}\n')
    out = os.path.join(ROOT, "_time_build", "phases")
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "chain_scan.cu")
    with open(cu, "w") as f:
        f.write(code)
    lib = os.path.join(out, "libchain_scan_phases.so")
    compact.nvcc_build(cu, lib)
    if n[0] != 6:
        raise AssertionError(f"expected 6 stamps in chain_marks_kernel, "
                             f"placed {n[0]}")
    return lib


def main():
    if not torch.cuda.is_available():
        print("chain_marks_phases: no CUDA device", file=sys.stderr)
        return 1
    lib = ctypes.CDLL(instrumented())
    lib.atpu_chain_marks.restype = ctypes.c_int
    lib.atpu_chain_marks.argtypes = ([ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.atpu_chain_stamps.restype = ctypes.c_int
    lib.atpu_chain_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    names = ("start", "stage", "sweep", "thread", "walk", "write")
    for label, name, args in tk.inputs(torch.device("cuda")):
        if name != "chain_marks":
            continue
        nxt, clen, _ = args
        out = torch.empty(nxt.shape, dtype=torch.bool, device=nxt.device)
        lib.atpu_chain_stamps(None, 1)
        err = lib.atpu_chain_marks(nxt.data_ptr(), clen.data_ptr(),
                                   out.data_ptr(), *nxt.shape,
                                   torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"chain_marks: CUDA error {err}")
        buf = (ctypes.c_ulonglong * 16)()
        lib.atpu_chain_stamps(ctypes.addressof(buf), 0)
        per = [buf[i] / buf[0] for i in range(1, 7)]
        print(f"[chain_marks phases] {label} {tuple(nxt.shape)}, "
              f"{buf[0]} CTAs: SM cycles per CTA " + ", ".join(
                  f"{k} {v:.0f}" for k, v in zip(names, per))
              + f"; total {sum(per):.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
