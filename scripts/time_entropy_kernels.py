#!/usr/bin/env python3
"""Device time of the two entropy-table kernels, kraft_absorb and
weights_fse_encode (aocl_compression_tpu_torch/csrc/entropy_scan.cu),
built from several source trees and timed on the same real inputs in one
process on one card.

    python3 scripts/time_entropy_kernels.py [--src DIR ...] [--set NAME=VALUE ...]

Each DIR is a checkout (or an unpacked archive of a commit) holding
aocl_compression_tpu_torch/csrc/entropy_scan.cu with the C entry points
atpu_kraft_absorb and atpu_weights_fse_encode; the current tree is always
timed, as "this tree". --set NAME=VALUE adds a copy of this tree with one
constant of entropy_scan.cu set anew (e.g. kKraftWarps=4: rows a CUDA
block). Each source is built with nvcc into DIR/_time_build and bound with
ctypes.

Inputs: chip_smoke.py's 16.8 MB corpus (256 blocks of 64 KiB, seed 42).
kraft_absorb: the (nbs, D) of zlib level 2's dynamic encoder
(make_encoder_dyn(65536, 4): 288 and 32 symbols, MAXLEN 15) and of zstd
level 1's encode_blocks (256 symbols, MAXLEN 11); weights_fse_encode: zstd
level 1's weight rows with the static weight table. Every build's outputs
are checked equal to this tree's wrapper's, then each is timed by
CUDA-graph replay of 20 calls (chip_smoke.graph_ms: the device time
without the host's launch gaps), in the order given and again in reverse
(A B B A). Beside them: an empty kernel launched the same way (ctypes, graph
replay) at one block of 32 threads and at 256 such blocks, the practical
launch floor. Per input it prints the ms of every build, the HBM bound
(each input read once, each output written once, at 3.35 TB/s), the serial
floor of the design of one thread a row (NSYM steps; 255 for the weights)
and of the run walk (the longest row's runs plus its steps with k > 0,
counted on the host from nbs and the plain version's k; 128 steps for the
weights: one lane a state), each at 30 SM cycles a step at the clock
nvidia-smi reads while this tree's kernel runs, and the card's name and
power limit; the last line is one JSON object with every time.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from aocl_compression_tpu_torch.ops import compact  # noqa: E402

_ENTRIES = {"kraft_absorb": (4, 3), "weights_fse_encode": (6, 2)}

_EMPTY = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int atpu_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def source(tree: str) -> str:
    return os.path.join(tree, "aocl_compression_tpu_torch", "csrc",
                        "entropy_scan.cu")


def bind(lib):
    """Declare the two C entry points of a build; returns lib."""
    for name, (nptr, nint) in _ENTRIES.items():
        fn = getattr(lib, "atpu_" + name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * nint
                       + [ctypes.c_void_p])
    return lib


def build(tree: str):
    """{kernel: ctypes function} of tree's entropy_scan.cu."""
    lib = os.path.join(tree, "_time_build", "libentropy_scan.so")
    compact.nvcc_build(source(tree), lib)
    lib = bind(ctypes.CDLL(lib))
    return {name: getattr(lib, "atpu_" + name) for name in _ENTRIES}


def variant(setting: str) -> str:
    """A copy of this tree's entropy_scan.cu with one constant set anew
    (setting "kKraftWarps=4": `constexpr int kKraftWarps = 4;`); returns
    the directory that holds it as a tree."""
    name, value = setting.split("=")
    code = open(source(ROOT)).read()
    new, n = re.subn(rf"constexpr (\w+) {name} = [^;]*;",
                     rf"constexpr \1 {name} = {value};", code)
    if n != 1:
        raise AssertionError(f"entropy_scan.cu has no one constexpr {name}")
    tree = os.path.join(ROOT, "_time_build", f"{name}_{value}")
    os.makedirs(os.path.dirname(source(tree)), exist_ok=True)
    with open(source(tree), "w") as f:
        f.write(new)
    return tree


def inputs(dev):
    """[(label, kernel, args)] of the captured real inputs, as the C entry
    points take them: kraft_absorb (nbs, D, MAXLEN), weights_fse_encode
    (weights, nxt, dnb, dfs)."""
    from aocl_compression_tpu_torch.ops import deflate_device as dd
    from aocl_compression_tpu_torch.ops import zstd_device as zd
    B, N = cs.B, cs.N
    data = cs.corpus(B * N)
    arr = torch.from_numpy(np.frombuffer(data, np.uint8).reshape(N, B)
                           .copy()).to(dev)
    lens = torch.full((N,), B, dtype=torch.int32, device=dev)
    enc = dd.make_encoder_dyn(B, 4)
    a288, a32 = cs.capture(dd, "_kraft_absorb", lambda: enc(arr, lens))
    del arr
    blocks = [data[i * B:(i + 1) * B] for i in range(N)]

    def encode():
        return zd.encode_blocks(blocks, 1, device=dev)

    a256 = cs.capture(zd, "_kraft_absorb", encode)[0]
    (w,), = cs.capture(zd, "_encode_weights", encode)
    c = zd._consts(dev)
    return [("zlib 2 literal/length, 288 symbols", "kraft_absorb", a288),
            ("zlib 2 distance, 32 symbols", "kraft_absorb", a32),
            ("zstd 1 literals, 256 symbols", "kraft_absorb", a256),
            ("zstd 1 weights, 255 a row", "weights_fse_encode",
             (w.contiguous(), c["w_nxt"], c["w_dnb"], c["w_dfs"]))]


def launcher(name, fn, args):
    """A call of fn on args into preallocated outputs: (call, outputs)."""
    if name == "kraft_absorb":
        nbs, d0, maxlen = args
        outs = (torch.empty_like(nbs), torch.empty_like(d0))
        ptrs = [nbs, d0, *outs]
        ints = (*nbs.shape, maxlen)
    else:
        w, nxt, dnb, dfs = args
        outs = (torch.empty((w.shape[0], 512), dtype=torch.uint8,
                            device=w.device),
                torch.empty((w.shape[0],), dtype=torch.int32,
                            device=w.device))
        ptrs = [w, nxt, dnb, dfs, *outs]
        ints = (w.shape[0], dnb.shape[0])
    ptrs = [p.data_ptr() for p in ptrs]

    def call():
        err = fn(*ptrs, *ints, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    return call, outs


def wrapper_outputs(name, args):
    from aocl_compression_tpu_torch.ops import entropy_scan
    if name == "kraft_absorb":
        return entropy_scan.kraft_absorb(*args)
    return entropy_scan.weights_fse_encode(*args)


def empty_floor(dev):
    """{label: ms} of the empty kernel by graph replay."""
    cu = os.path.join(ROOT, "_time_build", "empty.cu")
    os.makedirs(os.path.dirname(cu), exist_ok=True)
    if not os.path.exists(cu) or open(cu).read() != _EMPTY:
        with open(cu, "w") as f:
            f.write(_EMPTY)
    path = os.path.join(ROOT, "_time_build", "libempty.so")
    compact.nvcc_build(cu, path)
    fn = ctypes.CDLL(path).atpu_empty
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = {}
    for blocks in (1, 256):
        def call():
            if fn(blocks, 32, torch.cuda.current_stream(dev).cuda_stream):
                raise RuntimeError("empty kernel: launch failed")
        out[f"{blocks} x 32 threads"] = cs.graph_ms(call)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", default=[],
                    help="another source tree to time beside this one")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="also time this tree with one constant of "
                         "entropy_scan.cu set anew (e.g. kKraftWarps=4)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_entropy_kernels: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}")
    dev = torch.device("cuda")
    trees = ([("this tree", ROOT)] + [(d, d) for d in opts.src]
             + [(f"this tree, {v}", variant(v)) for v in opts.set])
    libs = {label: build(tree) for label, tree in trees}
    floor = empty_floor(dev)
    print("[empty kernel] graph replay, ctypes launch: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in floor.items()))
    times, bounds = {}, {}
    for label, name, args in inputs(dev):
        want = wrapper_outputs(name, args)
        calls = {}
        for tree, _ in trees:
            call, outs = launcher(name, libs[tree][name], args)
            call()
            torch.cuda.synchronize()
            if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                raise AssertionError(f"{name} of {tree} differs on {label}")
            calls[tree] = call
        order = list(calls) + list(reversed(calls))
        got = {tree: [] for tree in calls}
        for tree in order:
            got[tree].append(cs.graph_ms(calls[tree]))
        times[label] = got
        if name == "kraft_absorb":
            nbytes = cs.kraft_bytes(args[0])
            old, new = args[0].shape[1], cs.kraft_steps(args[0], want[0])
        else:
            nbytes = (args[0].shape[0] * (255 * 4 + 512 + 4)
                      + (64 + 2 * args[2].shape[0]) * 4)
            old, new = 255, 128
        mhz = cs.sm_clock_mhz(calls["this tree"])
        fl = {f"{k}_floor_ms": s * cs.FLOOR_CYCLES_PER_STEP / mhz / 1e3
              for k, s in (("old", old), ("new", new))}
        bounds[label] = dict(bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
                             old_steps=old, new_steps=new, mhz=mhz, **fl)
        b = bounds[label]
        print(f"[{name}] {label} ({tuple(args[0].shape)}): " + "; ".join(
            f"{tree} {' / '.join(f'{t:.4f}' for t in ts)} ms"
            for tree, ts in got.items())
            + f"; HBM bound {b['bound_ms']:.4f} ms; serial floor "
              f"{b['old_floor_ms']:.4f} ms one thread a row ({old} steps), "
              f"{b['new_floor_ms']:.4f} ms this design ({new} steps), at "
              f"{mhz:.0f} MHz x {cs.FLOOR_CYCLES_PER_STEP} cycles a step")
    print(json.dumps({"card": smi, "empty_ms": floor, "times": times,
                      "bounds": bounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
