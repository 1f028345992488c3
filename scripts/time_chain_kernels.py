#!/usr/bin/env python3
"""Device time of the two chain-marking kernels, subchain_reach and
chain_marks (aocl_compression_tpu_torch/csrc/chain_scan.cu), built from
several source trees and timed on the same real inputs in one process on
one card.

    python3 scripts/time_chain_kernels.py [--src DIR ...] [--set NAME=VALUE ...]

Each DIR is a checkout (or an unpacked archive of a commit) holding
aocl_compression_tpu_torch/csrc/chain_scan.cu with the C entry points
atpu_subchain_reach and atpu_chain_marks; the current tree is always
timed, as "this tree". --set NAME=VALUE adds a copy of this tree with
one constant of chain_scan.cu set anew, e.g. kWinSegs=128 (chain_marks'
windows of 128 segments: four CTAs a SM at one CTA a row, against two)
or kStageBatch=16 (its staging's loads in flight a thread). Each source
is built with nvcc into DIR/_time_build and bound with ctypes.

Inputs: chip_smoke.py's 16.8 MB corpus (256 blocks of 64 KiB, seed 42).
subchain_reach: the _reach_from_start arguments of the main path's encoder
(make_encoder(65536, 4): 256 x 16,384 tiles, SUBM 128) and of the bench
config's (G=8, subm 64). chain_marks: the _chain_marks arguments of the
LZ4 frame's device tier (one 64 KiB frame block at acceleration 1: its
greedy parse at N = 1 x 65,536, the shape of most of the kernel's
launches), of lz4hc 9's greedy parse (256 x 65,536), of the lz4 device
decoder on the lz4hc stream's chunks and of the snappy device decoder on
its stream, each as the wrapper takes it (int32). Every build's output
is checked equal to this tree's wrapper's, then each is timed by
CUDA-graph replay of 20 calls (chip_smoke.graph_ms: the device time
without the host's launch gaps, which a ctypes call from Python makes
longer than these kernels), in the order given and again in reverse (A B
B A).
Per input it prints the ms of every build, the HBM bound (each input read
once, the output written once, at 3.35 TB/s; chain_marks reads nxt only
below clen, chip_smoke.marks_bytes) and the longest lane's serial steps
(chip_smoke.marks_steps / reach_steps), and the card's name and power
limit; the last line is one JSON object with every time.
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

_ENTRIES = {"subchain_reach": (2, 3), "chain_marks": (3, 2)}


def _source(tree: str) -> str:
    return os.path.join(tree, "aocl_compression_tpu_torch", "csrc",
                        "chain_scan.cu")


def variant(setting: str) -> str:
    """A copy of this tree's chain_scan.cu with one constant set anew
    (setting "kWinSegs=128": `constexpr int kWinSegs = 128;`); returns the
    directory that holds it as a tree."""
    name, value = setting.split("=")
    code = open(_source(ROOT)).read()
    new, n = re.subn(rf"constexpr (\w+) {name} = [^;]*;",
                     rf"constexpr \1 {name} = {value};", code)
    if n != 1:
        raise AssertionError(f"chain_scan.cu has no one constexpr {name}")
    tree = os.path.join(ROOT, "_time_build", f"{name}_{value}")
    os.makedirs(os.path.dirname(_source(tree)), exist_ok=True)
    with open(_source(tree), "w") as f:
        f.write(new)
    return tree


def build(tree: str):
    """{kernel: ctypes function} of tree's chain_scan.cu."""
    lib = os.path.join(tree, "_time_build", "libchain_scan.so")
    compact.nvcc_build(_source(tree), lib)
    out = {}
    for name, (nptr, nint) in _ENTRIES.items():
        fn = getattr(ctypes.CDLL(lib), "atpu_" + name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * nint
                       + [ctypes.c_void_p])
        out[name] = fn
    return out


def inputs(dev):
    """[(label, kernel, args)] of the captured real inputs."""
    import aocl_compression_tpu_torch as act
    from aocl_compression_tpu_torch.codecs import lz4_frame
    from aocl_compression_tpu_torch.codecs.lz4hc import device_params
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    from aocl_compression_tpu_torch.ops import snappy_device as sd
    from aocl_compression_tpu_torch.runtime import native
    from aocl_compression_tpu_torch.utils.config import TIER_TORCH
    B, N = cs.B, cs.N
    data = cs.corpus(B * N)
    arr = torch.from_numpy(np.frombuffer(data, np.uint8).reshape(N, B)
                           .copy()).to(dev)
    lens = torch.full((N,), B, dtype=torch.int32, device=dev)
    out = []
    for label, enc in (
            ("main path, SUBM 128", ld.make_encoder(B, 4)),
            ("bench config, SUBM 64", ld.make_encoder(
                B, 8, 5, 5, subm=64, lazy=1, ext_passes=5))):
        nxt, subm = cs.capture(ld, "_reach_from_start",
                               lambda: enc(arr, lens))[0]
        out.append((label, "subchain_reach", (nxt, subm)))
    out.append(("frame path, one 64 KiB block", "chain_marks", cs.capture(
        ld, "_chain_marks", lambda: lz4_frame.compress_frame(
            data[:B], max_tier=TIER_TORCH, device=dev))[0]))
    depth, nw, lazy = device_params(9)
    mlen, _, valid = ld._find_matches(arr, lens, B, depth=depth, nw=nw)
    for _ in range(lazy):
        valid = ld._lazy_demote(mlen, valid)
    out.append(("lz4hc 9 greedy parse", "chain_marks", cs.capture(
        ld, "_chain_marks", lambda: ld._greedy_parse(mlen, valid, B))[0]))
    for method, decoder in (("lz4hc", ld), ("snappy", sd)):
        h = act.setup(method, opt_var=2, block_size=B)
        c = act.compress(h, data)
        act.destroy(h)
        offs, lens_, dlens = native.rap_parse(c)
        sel = [i for i, d in enumerate(dlens) if d <= ld.MAX_DEVICE_BLOCK]
        chunks = [c[int(offs[i]):int(offs[i]) + int(lens_[i])] for i in sel]
        dl = [int(dlens[i]) for i in sel]
        out.append((f"{method} stream's device decode", "chain_marks",
                    cs.capture(ld, "_chain_marks", lambda: decoder
                               .decode_blocks(chunks, dl, B, device=dev))[0]))
    return [(label, name, tuple(a.to(torch.int32).contiguous()
                                if isinstance(a, torch.Tensor) else a
                                for a in args))
            for label, name, args in out]


def launcher(name, fn, args):
    """A call of fn on args into a preallocated output: (call, output)."""
    if name == "subchain_reach":
        nxt, subm = args
        ptrs, ints = [nxt.data_ptr()], (*nxt.shape, subm)
    else:
        nxt, clen, _ = args
        ptrs, ints = [nxt.data_ptr(), clen.data_ptr()], tuple(nxt.shape)
    out = torch.empty(nxt.shape, dtype=torch.bool, device=nxt.device)
    ptrs.append(out.data_ptr())

    def call():
        err = fn(*ptrs, *ints, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    return call, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", default=[],
                    help="another source tree to time beside this one")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="also time this tree with one constant of "
                         "chain_scan.cu set anew (e.g. kWinSegs=128: "
                         "chain_marks' windows, so its CTAs a SM)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_chain_kernels: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}")
    from aocl_compression_tpu_torch.ops import chain_scan
    wrappers = {"subchain_reach": chain_scan.subchain_reach,
                "chain_marks": lambda nxt, clen, _: chain_scan.chain_marks(
                    nxt, clen)}
    dev = torch.device("cuda")
    trees = ([("this tree", ROOT)] + [(d, d) for d in opts.src]
             + [(f"this tree, {v}", variant(v)) for v in opts.set])
    libs = {label: build(tree) for label, tree in trees}
    times, bounds = {}, {}
    for label, name, args in inputs(dev):
        want = wrappers[name](*args)
        calls = {}
        for tree, _ in trees:
            call, out = launcher(name, libs[tree][name], args)
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{name} of {tree} differs on {label}")
            calls[tree] = call
        order = list(calls) + list(reversed(calls))
        got = {tree: [] for tree in calls}
        for tree in order:
            got[tree].append(cs.graph_ms(calls[tree]))
        times[label] = got
        nbytes = (cs.marks_bytes(args[0], args[1]) if name == "chain_marks"
                  else 5 * args[0].numel())
        steps = (cs.marks_steps(want) if name == "chain_marks"
                 else cs.reach_steps(want, args[1]))
        bounds[label] = dict(bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
                             steps=steps)
        print(f"[{name}] {label} ({tuple(args[0].shape)}): " + "; ".join(
            f"{tree} {' / '.join(f'{t:.4f}' for t in ts)} ms"
            for tree, ts in got.items())
            + f"; HBM bound {bounds[label]['bound_ms']:.4f} ms, longest "
              f"lane {steps} steps")
    print(json.dumps({"card": smi, "times": times, "bounds": bounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
