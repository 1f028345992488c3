#!/usr/bin/env python3
"""Where the two entropy-table kernels, kraft_absorb and weights_fse_encode
(aocl_compression_tpu_torch/csrc/entropy_scan.cu), spend their time: SM
cycles per warp in each of their phases, on the real inputs of
scripts/time_entropy_kernels.py.

    python3 scripts/entropy_phases.py [--src DIR ...]

It copies each tree's entropy_scan.cu into DIR/_time_build/phases/ with a
clock64() stamp at every phase mark (lane 0 of each warp adds the cycles
since its previous stamp to a device counter of that mark), builds the
copy with nvcc, runs it on each input and prints the cycles per warp of
each phase, averaged over the warps launched. A source that carries its
own marks (ATPU_PHASE_BEGIN / ATPU_PHASE(i, "name")) is stamped there; one
that has none (the design of one thread a row and 32 rows a CUDA block)
gets a mark at the kernel's start, after each __syncthreads() and at its
end: staging, chain, write-back. Beside the cycles it prints, from the
%globaltimer of the stamps, the span from the first warp's start to the
last warp's end and the spread of the warps' starts (ns), and the kernel's
graph-replay time (uninstrumented build); that time less the span is the
launch and the drain. The stamps add a few cycles each: the kernels'
times come from time_entropy_kernels.py, not from here. The current tree
is always run, as "this tree".
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as cs  # noqa: E402
import time_entropy_kernels as tk  # noqa: E402
from aocl_compression_tpu_torch.ops import compact  # noqa: E402

#: kernel -> (counter slot, phase names of a source without marks)
KERNELS = {"kraft_absorb": (0, ("staging", "chain", "write-back")),
           "weights_fse_encode": (1, ("staging", "chain and bit writer",
                                      "write-back"))}

_PRELUDE = r"""
#define ATPU_PHASES 1
// [k][0] warps stamped, [k][1..12] cycles of each phase, [k][13] first
// start, [k][14] last start, [k][15] last stamp (%globaltimer, ns)
__device__ unsigned long long g_phase[2][16];
__device__ __forceinline__ unsigned long long atpu_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define ATPU_PHASE_BEGIN(K)                                             \
  const int atpu_phk = (K);                                             \
  long long atpu_phl = clock64();                                       \
  if ((threadIdx.x & 31) == 0) {                                        \
    const unsigned long long g_ = atpu_gtime();                         \
    atomicAdd(&g_phase[K][0], 1ull);                                    \
    atomicMin(&g_phase[K][13], g_);                                     \
    atomicMax(&g_phase[K][14], g_);                                     \
  }
#define ATPU_PHASE(I, NAME)                                             \
  if ((threadIdx.x & 31) == 0) {                                        \
    const long long n_ = clock64();                                     \
    atomicAdd(&g_phase[atpu_phk][I], (unsigned long long)(n_ - atpu_phl)); \
    atpu_phl = n_;                                                      \
    atomicMax(&g_phase[atpu_phk][15], atpu_gtime());                    \
  }
"""

_ENTRIES = r"""
extern "C" int atpu_phase_clear() {
  unsigned long long z[2][16] = {};
  z[0][13] = z[1][13] = ~0ull;
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
extern "C" int atpu_phase_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
"""


def _body(code: str, kernel: str):
    """(start, end) of the body of __global__ kernel's definition: the
    index just past its opening brace and that of its closing one."""
    m = re.search(r"__global__[^;{]*?\b" + kernel + r"\s*\([^;{]*\)\s*\{",
                  code, re.S)
    if m is None:
        raise AssertionError(f"no __global__ definition of {kernel}")
    depth, i = 1, m.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(code[i], 0)
        i += 1
    return m.end(), i - 1


def instrument(code: str):
    """entropy_scan.cu with the stamps and their entry points; returns
    (code, {kernel: phase names})."""
    names = {}
    for kernel, (slot, default) in KERNELS.items():
        start, end = _body(code, kernel + "_kernel")
        body = code[start:end]
        if "ATPU_PHASE_BEGIN" in body:
            marks = re.findall(r'ATPU_PHASE\((\d+),\s*"([^"]+)"\)', body)
            if [int(i) for i, _ in marks] != list(range(1, len(marks) + 1)):
                raise AssertionError(f"{kernel}: marks not numbered 1..n")
            names[kernel] = [n for _, n in marks]
            continue
        n = [0]

        def mark(_):
            n[0] += 1
            return f'__syncthreads(); ATPU_PHASE({n[0]}, "")'

        body = re.sub(r"__syncthreads\(\);", mark, body)
        if n[0] != len(default) - 1:
            raise AssertionError(f"{kernel}: expected {len(default) - 1} "
                                 f"__syncthreads(), found {n[0]}")
        body = (f"\n  ATPU_PHASE_BEGIN({slot});" + body
                + f'  ATPU_PHASE({len(default)}, "");\n')
        code = code[:start] + body + code[end:]
        names[kernel] = list(default)
    return _PRELUDE + code + _ENTRIES, names


def build(tree: str):
    """(ctypes library, {kernel: phase names}) of tree's instrumented
    entropy_scan.cu, built into tree/_time_build/phases/."""
    src = tk.source(tree)
    code, names = instrument(open(src).read())
    out = os.path.join(tree, "_time_build", "phases")
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "entropy_scan.cu")
    if not os.path.exists(cu) or open(cu).read() != code:
        with open(cu, "w") as f:
            f.write(code)
    path = os.path.join(out, "libentropy_scan_phases.so")
    compact.nvcc_build(cu, path)
    lib = ctypes.CDLL(path)
    tk.bind(lib)
    lib.atpu_phase_clear.restype = ctypes.c_int
    lib.atpu_phase_read.restype = ctypes.c_int
    lib.atpu_phase_read.argtypes = [ctypes.c_void_p]
    return lib, names


def phases(lib, names, name, args, ms=None):
    """One stamped call of lib's kernel `name` on args (after three
    unstamped ones): dict(warps, cycles {phase: per warp}, span_ns,
    start_spread_ns, launch_drain_ms (with ms, the uninstrumented
    graph-replay time))."""
    call, _ = tk.launcher(name, getattr(lib, "atpu_" + name), args)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    if lib.atpu_phase_clear():
        raise RuntimeError("atpu_phase_clear failed")
    call()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 32)()
    if lib.atpu_phase_read(ctypes.addressof(buf)):
        raise RuntimeError("atpu_phase_read failed")
    k = KERNELS[name][0] * 16
    warps = buf[k]
    cyc = {p: buf[k + 1 + i] / warps for i, p in enumerate(names[name])}
    span = buf[k + 15] - buf[k + 13]
    out = dict(warps=warps, cycles=cyc, span_ns=span,
               start_spread_ns=buf[k + 14] - buf[k + 13])
    if ms is not None:
        out["launch_drain_ms"] = ms - span / 1e6
    return out


def line(tag, label, res):
    """The printed line of one phases() result."""
    cyc = res["cycles"]
    s = (f"[{tag}] {label}: SM cycles per warp ({res['warps']} warps) "
         + ", ".join(f"{p} {v:.0f}" for p, v in cyc.items())
         + f"; total {sum(cyc.values()):.0f}; span first start to last "
           f"end {res['span_ns']} ns, starts spread over "
           f"{res['start_spread_ns']} ns (%globaltimer)")
    if "launch_drain_ms" in res:
        s += (f"; graph-replay time less the span (launch and drain) "
              f"{res['launch_drain_ms']:.4f} ms")
    return s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", default=[],
                    help="another source tree to stamp beside this one")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("entropy_phases: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}")
    trees = [("this tree", ROOT)] + [(d, d) for d in opts.src]
    built = {label: build(tree) for label, tree in trees}
    plain = {label: tk.build(tree) for label, tree in trees}
    for label, name, args in tk.inputs(torch.device("cuda")):
        for tree, (lib, names) in built.items():
            call, _ = tk.launcher(name, plain[tree][name], args)
            res = phases(lib, names, name, args, cs.graph_ms(call))
            print(line(f"{name} phases", f"{tree}, {label}", res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
