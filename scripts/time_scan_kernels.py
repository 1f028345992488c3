#!/usr/bin/env python3
"""Device time of the four scan kernels, inflate_symbol_scan
(aocl_compression_tpu_torch/csrc/inflate_scan.cu) and fse_encode_scan,
huf_literal_scan and fse_sequence_scan (csrc/zstd_scan.cu), built from
several source trees and timed on the same real inputs in one process on
one card.

    python3 scripts/time_scan_kernels.py [--src DIR ...]

Each DIR is a checkout (or an unpacked archive of a commit) holding
aocl_compression_tpu_torch/csrc/{inflate_scan,zstd_scan}.cu with the C
entry points atpu_inflate_symbol_scan, atpu_fse_encode_scan,
atpu_huf_literal_scan and atpu_fse_sequence_scan; the current tree is
always timed, as "this tree". Each source is built with nvcc into
DIR/_time_build and bound with ctypes.

Inputs: chip_smoke.py's 16.8 MB corpus (256 blocks of 64 KiB, seed 42)
compressed through the port's API with setup("zlib", level=1, opt_var=2)
and setup("zstd", level=1, opt_var=2); the arguments of the zstd
encoder's _fse_scan call are captured during that compress, and those of
the device decoders' _scan_compact, _literal_scan and _sequence_scan calls
while they decode the streams. Every build's outputs are checked equal to
this tree's wrapper's, output for output (huf_literal_scan's on the slots
below each lane's count, the only ones it writes), then each is timed over
5 back-to-back calls between CUDA events (a call takes at least a tenth of
a millisecond, so the launch gaps are small beside it), in the order given
and again in reverse (A B B A). Per kernel it prints the ms, the longest
lane's serial steps, µs and SM cycles per step (the clock read by
nvidia-smi while the kernel runs) and the card's name and power limit; the
last line is one JSON object with every time.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from aocl_compression_tpu_torch.ops import compact  # noqa: E402

_KERNELS = {"inflate_symbol_scan": ("inflate_scan.cu", 16, 4),
            "fse_encode_scan": ("zstd_scan.cu", 8, 2),
            "huf_literal_scan": ("zstd_scan.cu", 6, 3),
            "fse_sequence_scan": ("zstd_scan.cu", 8, 3)}


def build(tree: str):
    """{kernel: ctypes function} of the sources under tree."""
    out = {}
    for name, (src, nptr, nint) in _KERNELS.items():
        path = os.path.join(tree, "aocl_compression_tpu_torch", "csrc", src)
        lib = os.path.join(tree, "_time_build",
                           "lib" + src.replace(".cu", ".so"))
        compact.nvcc_build(path, lib)
        fn = getattr(ctypes.CDLL(lib), "atpu_" + name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * nint
                       + [ctypes.c_void_p])
        out[name] = fn
    return out


def inputs(dev):
    """The captured kernel arguments (as the wrappers take them) of the
    zlib-1 inflate batch, the zstd-1 encoder's FSE scan and the zstd-1
    decoder's literal and sequence batches."""
    import aocl_compression_tpu_torch as act
    from aocl_compression_tpu_torch.codecs.zlib_bzip2_lzma import (
        _inflate_host)
    from aocl_compression_tpu_torch.ops import inflate_device as idev
    from aocl_compression_tpu_torch.ops import zstd_decode_device as zdd
    from aocl_compression_tpu_torch.ops import zstd_device as zd
    from aocl_compression_tpu_torch.runtime import native
    data = cs.corpus(cs.B * cs.N)
    streams = {}
    for codec in ("zlib", "zstd"):
        h = act.setup(codec, level=1, opt_var=2)
        streams[codec] = act.compress(h, data)
        act.destroy(h)
    h = act.setup("zstd", level=1, opt_var=2)
    enc = cs.capture(zd, "_fse_scan", lambda: act.compress(h, data))[0]
    act.destroy(h)
    c = streams["zlib"]
    offs, lens_, dlens = native.rap_parse(c)
    chunks = [c[int(o):int(o) + int(n)] for o, n in zip(offs, lens_)]
    inf = cs.capture(idev, "_scan_compact", lambda: idev.decode_chunks(
        chunks, [int(x) for x in dlens], device=dev,
        host_one=_inflate_host))[0]
    c = streams["zstd"]
    offs, lens_, dlens = native.rap_parse(c[8:])
    chunks = [c[8 + int(o):8 + int(o) + int(n)] for o, n in zip(offs, lens_)]

    def decode():
        zdd.decode_chunks(chunks, [int(x) for x in dlens], device=dev,
                          host_decode=native.zstd_decompress)

    lit = cs.capture(zdd, "_literal_scan", decode)[0]
    seq = cs.capture(zdd, "_sequence_scan", decode)[0]
    logs = torch.stack(seq[4:7], dim=1).to(torch.int32).contiguous()
    return {"inflate_symbol_scan": inf, "fse_encode_scan": list(enc),
            "huf_literal_scan": list(lit),
            "fse_sequence_scan": list(seq[:4]) + [logs, seq[7]]}


def launcher(name, fn, args):
    """A call of fn on args into preallocated outputs; returns (call,
    outputs)."""
    dev = args[0].device
    i32 = torch.int32
    if name == "inflate_symbol_scan":
        *ts, B, MAXSEQ = args
        N, C = ts[0].shape
        outs = [torch.empty((N, B), dtype=torch.uint8, device=dev)] + [
            torch.empty((N, MAXSEQ), dtype=i32, device=dev)
            for _ in range(3)] + [
            torch.empty(N, dtype=i32, device=dev) for _ in range(2)]
        ints = (N, C, B, MAXSEQ)
    elif name == "fse_encode_scan":
        ts = list(args)
        N, MAXSEQ = ts[0].shape[:2]
        outs = [torch.empty((N, MAXSEQ, 6), dtype=i32, device=dev)
                for _ in range(2)] + [
            torch.empty((N, 3), dtype=i32, device=dev)]
        ints = (N, MAXSEQ)
    elif name == "huf_literal_scan":
        *ts, MAXL = args
        L, SB = ts[0].shape
        outs = [torch.empty((L, MAXL), dtype=torch.uint8, device=dev)]
        ints = (L // 4, SB, MAXL)
    else:
        *ts, MAXSEQ = args
        N, QB = ts[0].shape
        outs = [torch.empty((N, MAXSEQ), dtype=i32, device=dev)
                for _ in range(3)]
        ints = (N, QB, MAXSEQ)
    ptrs = [t.data_ptr() for t in ts + outs]

    def call():
        err = fn(*ptrs, *ints, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    return call, outs


def same(name, args, outs, want):
    """outs equal to the wrapper's want on every output the kernel
    defines (huf_literal_scan writes only the slots below each count)."""
    if name == "huf_literal_scan":
        MAXL = args[-1]
        live = (torch.arange(MAXL, device=args[2].device)[None]
                < torch.clamp(args[2], max=MAXL)[:, None])
        return torch.equal(outs[0][live], want[live])
    if isinstance(want, torch.Tensor):
        want = [want]
    return all(torch.equal(o, w) for o, w in zip(outs, want))


def steps_of(name, args, want):
    if name == "inflate_symbol_scan":
        return int(torch.clamp(want[4] + want[5] + 1, max=args[-2] + 4).max())
    if name == "fse_encode_scan":
        return int(torch.clamp(args[1], 0, args[0].shape[1]).max())
    return int(torch.clamp(args[2], max=args[-1]).max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", default=[],
                    help="another source tree to time beside this one")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_scan_kernels: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}")
    from aocl_compression_tpu_torch.ops import inflate_scan, zstd_scan
    wrappers = {"inflate_symbol_scan": inflate_scan.inflate_symbol_scan,
                "fse_encode_scan": zstd_scan.fse_encode_scan,
                "huf_literal_scan": zstd_scan.huf_literal_scan,
                "fse_sequence_scan": zstd_scan.fse_sequence_scan}
    dev = torch.device("cuda")
    trees = [("this tree", ROOT)] + [(d, d) for d in opts.src]
    libs = {label: build(tree) for label, tree in trees}
    args = inputs(dev)
    times = {}
    for name, a in args.items():
        want = wrappers[name](*a)
        torch.cuda.synchronize()
        steps = steps_of(name, a, want)
        calls = {}
        for label, _ in trees:
            call, outs = launcher(name, libs[label][name], a)
            call()
            torch.cuda.synchronize()
            if not same(name, a, outs, want):
                raise AssertionError(f"{name} from {label} differs from "
                                     f"this tree's wrapper")
            calls[label] = call
        order = [t[0] for t in trees]
        for label in order + order[::-1]:
            ms = cs.cuda_ms(calls[label], 5)
            times.setdefault(name, {}).setdefault(label, []).append(ms)
        for label in order:
            ms = min(times[name][label])
            mhz = cs.sm_clock_mhz(calls[label])
            us = ms / steps * 1e3
            print(f"[{name}] {label}: {times[name][label]} ms (CUDA "
                  f"events, A B B A), longest lane {steps} steps, "
                  f"{us:.4f} us and {us * mhz:.1f} SM cycles per step at "
                  f"{mhz:.0f} MHz")
    print(json.dumps({"card": smi, "times_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
