#!/usr/bin/env python3
"""Device time of the sort-emit kernels (aocl_compression_tpu_torch/csrc/
emit_sorted.cu: emit_lz4, emit_snappy) built from several sources and
timed on the same real inputs in one process on one card.

    python3 scripts/time_emit_kernels.py [--src DIR ...] [--set NAME=VALUE ...]

Each DIR is a checkout (or an unpacked archive of a commit) holding
aocl_compression_tpu_torch/csrc/emit_sorted.cu with the C entry point
atpu_emit_sorted. The current tree is always timed, as "this tree".
--set NAME=VALUE adds a copy of this tree with one constant of
emit_sorted.cu set anew, e.g. kTilesPerThread=8 (chunks of 8,192 tiles).
Each source is built with nvcc into _time_build/emit_<n>/ (git-ignored)
and bound with ctypes.

Inputs: the real serializer call of each path of chip_smoke.py on its 16.8
MB corpus (256 blocks of 64 KiB, seed 42): the lz4 main path (G = 4),
snappy (G = 4), the bench config (G = 8), the main path's first 64 rows
(a shard of phase 13's four virtual shards) and its first row (N = 1, the
frame path's shape). For each input and source, by CUDA-graph replay of
20 launches (chip_smoke.graph_ms), in the order given and again in
reverse (A B B A), after each source's outputs are checked equal to this
tree's wrapper's. It prints each time beside the HBM bound
(chip_smoke.emit_bytes: each input read once, each output written once,
at 3.35 TB/s), ptxas's registers and spills of each build, and the card's
name and power limit; the last line is one JSON object with every time.
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


def _source(tree: str) -> str:
    return os.path.join(tree, "aocl_compression_tpu_torch", "csrc",
                        "emit_sorted.cu")


def variant(setting: str) -> str:
    """A copy of this tree's emit_sorted.cu with one constant set anew;
    returns the directory that holds it as a tree."""
    name, value = setting.split("=")
    code = open(_source(ROOT)).read()
    new, n = re.subn(rf"constexpr (\w+) {name} = [^;]*;",
                     rf"constexpr \1 {name} = {value};", code)
    if n != 1:
        raise AssertionError(f"emit_sorted.cu has no one constexpr {name}")
    tree = os.path.join(ROOT, "_time_build", f"{name}_{value}")
    os.makedirs(os.path.dirname(_source(tree)), exist_ok=True)
    with open(_source(tree), "w") as f:
        f.write(new)
    return tree


def build(tree: str, k: int):
    """(ctypes library, ptxas lines) of the tree's emit_sorted.cu."""
    lib = os.path.join(ROOT, "_time_build", f"emit_{k}", "libemit_sorted.so")
    log = compact.nvcc_build(_source(tree), lib)
    handle = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.atpu_emit_sorted.restype = i
    handle.atpu_emit_sorted.argtypes = (
        [i] + [p] * 6 + [ctypes.POINTER(ctypes.c_longlong)] + [p] * 4
        + [i] * 3 + [p])
    return handle, [ln.strip() for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln]


def launcher(handle, fmt: int, args):
    """A function launching the source's kernel on args into preallocated
    outputs, and the outputs."""
    data, n, sel, cpos, cml, coff, Bk, G = args
    N = data.shape[0]
    dev = data.device
    outs = (torch.empty((N, Bk), dtype=torch.uint8, device=dev),
            torch.empty((N,), dtype=torch.int32, device=dev),
            torch.empty((N,), dtype=torch.int32, device=dev),
            torch.empty((N,), dtype=torch.bool, device=dev))
    strides = (ctypes.c_longlong * 8)(
        *(s for t in (sel, cpos, cml, coff) for s in t.stride()))

    def run():
        err = handle.atpu_emit_sorted(
            fmt, data.data_ptr(), n.data_ptr(), sel.data_ptr(),
            cpos.data_ptr(), cml.data_ptr(), coff.data_ptr(), strides,
            *(o.data_ptr() for o in outs), N, Bk, G,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    return run, outs


def inputs(dev):
    """name -> (format, the serializer's arguments) of each path."""
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    from aocl_compression_tpu_torch.ops import snappy_device as sd
    B, N = cs.B, cs.N
    data = cs.corpus(B * N)
    arr = torch.from_numpy(np.frombuffer(data, np.uint8).reshape(N, B)
                           .copy()).to(dev)
    lens = torch.full((N,), B, dtype=torch.int32, device=dev)
    main = cs.capture(ld, "_emit_sorted",
                      lambda: ld.make_encoder(B, 4)(arr, lens))[0]
    snappy = cs.capture(sd, "_emit_snappy_sorted",
                        lambda: sd.make_encoder(B, 4)(arr, lens))[0]
    bench = cs.capture(ld, "_emit_sorted", lambda: ld.make_encoder(
        B, 8, 5, 5, subm=64, lazy=1, ext_passes=5)(arr, lens))[0]

    def rows(args, k):
        return tuple(a[:k] for a in args[:6]) + args[6:]

    return {"lz4 main path (N=256, G=4)": ("lz4", main),
            "snappy (N=256, G=4)": ("snappy", snappy),
            "bench config (N=256, G=8)": ("lz4", bench),
            "a shard (N=64, G=4)": ("lz4", rows(main, 64)),
            "one block (N=1, G=4)": ("lz4", rows(main, 1))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--set", action="append", default=[])
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_emit_kernels: no CUDA device", file=sys.stderr)
        return 1
    from aocl_compression_tpu_torch.ops import emit_sorted as es
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    trees = ([("this tree", ROOT)] + [(d, os.path.abspath(d)) for d in a.src]
             + [(f"this tree, {s}", variant(s)) for s in a.set])
    libs = {}
    for k, (label, tree) in enumerate(trees):
        libs[label], ptxas = build(tree, k)
        print(f"[build] {label}: " + "; ".join(ptxas))
    dev = torch.device("cuda")
    res = {}
    for name, (fmt, args) in inputs(dev).items():
        want = getattr(es, f"emit_{fmt}")(*args)
        runs = {}
        for label, _ in trees:
            run, outs = launcher(libs[label], 0 if fmt == "lz4" else 1, args)
            run()
            try:
                torch.cuda.synchronize()
            except RuntimeError:
                print(f"{label} failed on {name}", flush=True)
                raise
            if not all(torch.equal(g, w) for g, w in zip(outs, want)):
                raise AssertionError(f"{label} differs on {name}")
            runs[label] = run
        times = {label: [] for label, _ in trees}
        for label, _ in trees + trees[::-1]:
            times[label].append(cs.graph_ms(runs[label]))
        N, Bk, G = args[0].shape[0], args[6], args[7]
        bound = cs.emit_bytes(N, Bk, G) / cs.HBM_BYTES_PER_S * 1e3
        res[name] = dict(times=times, bound_ms=bound)
        print(f"[{name}] bound {bound:.4f} ms; " + "; ".join(
            f"{label} {', '.join(f'{t:.4f}' for t in ts)} ms"
            for label, ts in times.items()), flush=True)
    print(json.dumps({"card": smi, "inputs": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
