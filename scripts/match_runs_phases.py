#!/usr/bin/env python3
"""Where match_runs (aocl_compression_tpu_torch/csrc/match_find.cu) spends
its time: SM cycles per CTA in each of its phases, on the real inputs of
scripts/time_match_kernels.py (the LZ4 frame's N = 1 block, a shard of four
virtual shards at N = 64, the lz4 main path's 256 rows and the bench
config's 256 rows with the ladder).

    python3 scripts/match_runs_phases.py [--src DIR ...]

It copies each tree's match_find.cu into _time_build/runs_phases_<k>/
with a barrier of the CTA and a clock64() stamp at each phase mark
(thread 0 of each CTA adds the cycles since its previous stamp to a
device counter of that mark, so the cycles are the CTA's slowest warp's),
builds the copy with nvcc, runs its match_runs once on each
input (the best candidates from this tree's match_keys and
match_candidates) and prints the cycles per CTA of each phase, summed
over the CTAs and divided by their number. A source with its own marks
(ATPU_PHASE_BEGIN() / ATPU_PHASE(i, "name")) is stamped there; one without
them (the earlier design of one CTA a row, e.g. `git archive 4c6d9a1
aocl_compression_tpu_torch/csrc/match_find.cu | tar -x -C _proof/earlier`)
gets a mark after each __syncthreads() of match_runs_kernel and a barrier
and a mark where it returns without the ladder and at its end. The
stamps add a few cycles each: the kernel's time comes from
time_match_kernels.py, not from here. The current tree is always run,
as "this tree".
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

import time_match_kernels as tk  # noqa: E402
from aocl_compression_tpu_torch.ops import compact  # noqa: E402

INPUTS = ("frame path, N = 1", "a shard of 4 virtual shards, N = 64",
          "lz4 main path", "bench config")
_KERNEL = "match_runs_kernel(const uint8_t* __restrict__ data,"
_PRELUDE = r"""
#define ATPU_PHASES 1
// [0] CTAs stamped, [i] cycles of mark i summed over the CTAs
__device__ unsigned long long g_runs_phase[16];
#define ATPU_PHASE_BEGIN()                                      \
  long long atpu_last = clock64();                              \
  if (threadIdx.x == 0) atomicAdd(&g_runs_phase[0], 1ull)
#define ATPU_PHASE(I, NAME)                                     \
  __syncthreads();                                              \
  if (threadIdx.x == 0) {                                       \
    const long long atpu_now = clock64();                       \
    atomicAdd(&g_runs_phase[I],                                 \
              (unsigned long long)(atpu_now - atpu_last));      \
    atpu_last = atpu_now;                                       \
  }
"""
_READ = r"""
extern "C" int atpu_runs_stamps(void* out, int clear) {
  if (clear) {
    unsigned long long z[16] = {};
    return (int)cudaMemcpyToSymbol(g_runs_phase, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_runs_phase, sizeof(g_runs_phase));
}
"""
# the marks placed in a source without them: after each __syncthreads()
# of the kernel, where it returns without the ladder, at its end
_OLD_NAMES = ("staging", "first disagreement",
              "backward pass and finish (no ladder)", "backward pass",
              "links", "walk and finish (rounds of the CTA's threads)",
              "last round's finish")


def instrumented(tree: str, k: int):
    """(library path, {mark: name}) of tree's match_find.cu with stamps."""
    src = open(tk._source(tree)).read()
    names = {int(i): nm for i, nm in
             re.findall(r'ATPU_PHASE\((\d+), "([^"]+)"\)', src)}
    if not names:
        head, body = src.split(_KERNEL, 1)
        kern, tail = body.split("// Above 48 KB", 1)
        n = [0]

        def mark(_):
            n[0] += 1
            return f'__syncthreads(); ATPU_PHASE({n[0]}, "");'

        kern = kern.replace("uint8_t row[];\n",
                            "uint8_t row[];\n  ATPU_PHASE_BEGIN();\n", 1)
        kern = kern.replace("  if (!kLadder) return;\n", "  if (!kLadder) {"
                            " __syncthreads(); ATPU_PHASE(3, \"\"); return; "
                            "}\n", 1)
        pre, sync = kern.split("  if (!kLadder) {", 1)
        pre = re.sub(r"__syncthreads\(\);", mark, pre)    # marks 1, 2
        n[0] = 3
        sync = "  if (!kLadder) {" + sync
        post_at = sync.index("}\n", sync.index("return;")) + 2
        post = re.sub(r"__syncthreads\(\);", mark, sync[post_at:])
        end = post.rindex("}")
        n[0] += 1
        post = (post[:end] + f'  __syncthreads(); ATPU_PHASE({n[0]}, "");\n'
                + post[end:])
        src = head + _KERNEL + pre + sync[:post_at] + post + "// Above 48 KB" \
            + tail
        names = dict(enumerate(_OLD_NAMES, 1))
        if n[0] != len(_OLD_NAMES):
            raise AssertionError(f"{tree}: placed {n[0]} marks in "
                                 f"match_runs_kernel, expected "
                                 f"{len(_OLD_NAMES)}")
    out = os.path.join(ROOT, "_time_build", f"runs_phases_{k}")
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "match_find.cu")
    with open(cu, "w") as f:
        f.write(_PRELUDE + src + _READ)
    lib = os.path.join(out, "libmatch_find_phases.so")
    compact.nvcc_build(cu, lib)
    return lib, names


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", default=[],
                    help="another source tree to stamp beside this one")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("match_runs_phases: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}")
    from aocl_compression_tpu_torch.ops import match_find as mf
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = []
    for k, (label, tree) in enumerate([("this tree", ROOT)]
                                      + [(d, d) for d in opts.src]):
        path, names = instrumented(tree, k)
        so = ctypes.CDLL(path)
        so.atpu_match_runs.restype = i
        so.atpu_match_runs.argtypes = ([p] * 6 + [i, i, ctypes.POINTER(i)]
                                       + [i] * 3 + [p])
        so.atpu_runs_stamps.restype = i
        so.atpu_runs_stamps.argtypes = [p, i]
        libs.append((label, so, names))
    for label, (data, n, Bk), kw in tk.inputs(torch.device("cuda")):
        if label not in INPUTS:
            continue
        N = data.shape[0]
        skey = mf.match_keys(data, Bk, kw["hash_bits"])
        best = mf.match_candidates(data, skey, Bk, kw["max_off"],
                                   kw["depth"], kw["nw"], kw["nw_deep"])
        want = mf.match_runs(data, best, n, Bk, kw["small_offsets"],
                             kw["nw"], kw["ext_passes"])
        offs = [int(o) for o in kw["small_offsets"]]
        arr = (ctypes.c_int * 8)(*offs)
        ctas = mf.runs_ctas(N, Bk, kw["small_offsets"], kw["nw"],
                            kw["ext_passes"])
        for tree, so, names in libs:
            outs = [torch.empty_like(w) for w in want]

            def run():
                err = so.atpu_match_runs(
                    data.data_ptr(), best.data_ptr(), n.data_ptr(),
                    *(o.data_ptr() for o in outs), N, Bk, arr, len(offs),
                    kw["ext_passes"], kw["nw"],
                    torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f"match_runs: CUDA error {err}")

            run()    # the opt-in and the first launch's costs
            so.atpu_runs_stamps(None, 1)
            run()
            if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                raise AssertionError(f"{tree}: the stamped match_runs "
                                     f"differs on {label}")
            buf = (ctypes.c_ulonglong * 16)()
            so.atpu_runs_stamps(ctypes.addressof(buf), 0)
            per = {names[m]: buf[m] / buf[0] for m in sorted(names)
                   if buf[m]}
            print(f"[match_runs phases] {tree}, {label} (N={N}, B={Bk}, "
                  f"ext_passes {kw['ext_passes']}; {buf[0]} CTAs, this "
                  f"tree's plan {ctas} a row): SM cycles per CTA "
                  + ", ".join(f"{k} {v:.0f}" for k, v in per.items())
                  + f"; total {sum(per.values()):.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
