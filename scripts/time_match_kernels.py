#!/usr/bin/env python3
"""Device time of the match finder's kernels (aocl_compression_tpu_torch/
csrc/match_find.cu) built from several source trees and timed on the same
real inputs in one process on one card.

    python3 scripts/time_match_kernels.py [--src DIR ...] [--set NAME=VALUE ...]

Each DIR is a checkout (or an unpacked archive of a commit) holding
aocl_compression_tpu_torch/csrc/match_find.cu with the C entry points
atpu_match_keys, atpu_match_candidates and atpu_match_runs, e.g. the first
design of the kernels:

    mkdir -p _proof/pr16 && git archive 2857386 \\
        aocl_compression_tpu_torch/csrc/match_find.cu | tar -x -C _proof/pr16

The current tree is always timed, as "this tree". --set NAME=VALUE adds a
copy of this tree with one constant of match_find.cu set anew, e.g.
kMaxCluster=1 (match_keys on one CTA a row at every N), kMinSlice=512
(match_candidates' rows cut into fewer slices at small N), kMaxRunCluster=8
(match_runs on up to 8 CTAs a row) or kRunAhead=8 (match_runs reading
the best candidates of 8 tiles ahead, 16 with the ladder). Each source is built with nvcc into
_time_build/match_<n>/ (git-ignored) and bound with ctypes.
A tree whose match_keys gives the keys unsorted (the first design) is
followed by torch.sort of them, as its caller did.

Inputs: the real _find_matches call of each path of chip_smoke.py on its
16.8 MB corpus (256 blocks of 64 KiB, seed 42): the lz4 main path (depth
4, nw 8), the bench config (5, 5, ladder), one shard of the lz4 encoder
on four virtual shards of the card (N = 64, phase 13), zlib 1 (max_off
32,768), zstd 1 (depth 8), the lzma 6 assist (depth 16), lz4hc 9 (depth
11, nw 32) and the LZ4 frame's device tier on one 64 KiB block (N = 1);
with this tree's match_runs CTAs a row at each. For each input and
tree, by CUDA-graph replay of 20 calls (chip_smoke.graph_ms), in the order
given and again in reverse (A B B A): match_keys (with the first design's
torch.sort after it, and that sort alone), match_candidates on the same
sorted keys, match_runs, and the whole kernel path. Every tree's outputs
are checked equal to this tree's wrapper's first. Beside them, on each
N = 256 input, the cost of match_candidates' store pattern alone: one
int32 a position written in sorted-key order (index_copy_ at the sorted
keys' positions, the scattered 4-byte stores) against the same bytes
written in order (copy_). It prints each time, the
HBM bounds (chip_smoke.match_bytes: each input read once, each output
written once, at 3.35 TB/s), ptxas's registers and spills of each build,
and the card's name and power limit; the last line is one JSON object with
every time.
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
                        "match_find.cu")


def variant(setting: str) -> str:
    """A copy of this tree's match_find.cu with one constant set anew
    (setting "kMinSlice=256": `constexpr int kMinSlice = 256;`); returns
    the directory that holds it as a tree."""
    name, value = setting.split("=")
    code = open(_source(ROOT)).read()
    new, n = re.subn(rf"constexpr (\w+) {name} = [^;]*;",
                     rf"constexpr \1 {name} = {value};", code)
    if n != 1:
        raise AssertionError(f"match_find.cu has no one constexpr {name}")
    tree = os.path.join(ROOT, "_time_build", f"{name}_{value}")
    os.makedirs(os.path.dirname(_source(tree)), exist_ok=True)
    with open(_source(tree), "w") as f:
        f.write(new)
    return tree


def build(tree: str, k: int):
    """(ctypes library, ptxas lines) of tree's match_find.cu."""
    lib = os.path.join(ROOT, "_time_build", f"match_{k}", "libmatch_find.so")
    log = compact.nvcc_build(_source(tree), lib)
    so = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("atpu_match_keys", [p, p, i, i, i]),
                       ("atpu_match_candidates", [p, p, p] + [i] * 6),
                       ("atpu_match_runs",
                        [p] * 6 + [i, i, ctypes.POINTER(i)] + [i] * 3)):
        fn = getattr(so, name)
        fn.restype = i
        fn.argtypes = args + [p]
    lines = [ln.strip() for ln in log.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    return so, lines


def inputs(dev):
    """[(label, (data, n, B), kw)] of the captured real calls."""
    import aocl_compression_tpu_torch as act
    from aocl_compression_tpu_torch.codecs import lz4_frame
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    from aocl_compression_tpu_torch.parallel import sharded
    from aocl_compression_tpu_torch.utils.config import TIER_TORCH
    B, N = cs.B, cs.N
    data = cs.corpus(B * N)
    arr = torch.from_numpy(np.frombuffer(data, np.uint8).reshape(N, B)
                           .copy()).to(dev)
    lens = torch.full((N,), B, dtype=torch.int32, device=dev)
    bench = ld.make_encoder(B, 8, 5, 5, subm=64, lazy=1, ext_passes=5)
    runs = [("lz4 main path", dict(method="lz4")),
            ("bench config", None),
            ("a shard of 4 virtual shards, N = 64", None),
            ("zlib 1", dict(method="zlib", level=1)),
            ("zstd 1", dict(method="zstd", level=1)),
            ("lzma 6 assist", dict(method="lzma", level=6)),
            ("lz4hc 9", dict(method="lz4hc", level=9)),
            ("frame path, N = 1", None)]
    out = []
    for label, kw in runs:
        if label == "bench config":
            run = lambda: bench(arr, lens)  # noqa: E731
        elif label.startswith("a shard"):
            blocks = [data[i * B:(i + 1) * B] for i in range(N)]
            run = lambda: sharded.compress_blocks_multi(  # noqa: E731
                blocks, 2, 4, device=dev, devices=[dev] * 4)
        elif label.startswith("frame"):
            run = lambda: lz4_frame.compress_frame(  # noqa: E731
                data[:B], max_tier=TIER_TORCH, device=dev)
        else:
            kw = dict(kw)
            method = kw.pop("method")
            extra = {} if method in ("lzma", "zlib") else dict(block_size=B)
            h = act.setup(method, opt_var=2, **kw, **extra)
            run = lambda: act.compress(h, data)  # noqa: E731
        (d, n, Bk), fkw = cs.find_matches_call(run)
        out.append((label, (d.contiguous(), n.to(torch.int32).contiguous(),
                            Bk), fkw))
    return out


def paths(so, sorts: bool, data, n, Bk, kw, bufs):
    """Calls of one build on one input: {stage: call}. sorts: the build's
    match_keys gives the keys unsorted (a torch.sort follows it)."""
    key, skey, best, mlen, moff, valid = bufs
    N = data.shape[0]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    offs = [int(o) for o in kw["small_offsets"]]
    arr = (ctypes.c_int * 8)(*offs)

    def check(err, name):
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def keys():
        check(so.atpu_match_keys(data.data_ptr(), key.data_ptr(), N, Bk,
                                 kw["hash_bits"], stream()), "match_keys")

    def keys_sorted():
        keys()
        skey.copy_(torch.sort(key, dim=-1).values if sorts else key)

    def cand():
        check(so.atpu_match_candidates(
            data.data_ptr(), skey.data_ptr(), best.data_ptr(), N, Bk,
            kw["depth"], kw["nw"], kw["nw_deep"], kw["max_off"], stream()),
            "match_candidates")

    def runs():
        check(so.atpu_match_runs(
            data.data_ptr(), best.data_ptr(), n.data_ptr(), mlen.data_ptr(),
            moff.data_ptr(), valid.data_ptr(), N, Bk, arr, len(offs),
            kw["ext_passes"], kw["nw"], stream()), "match_runs")

    def whole():
        keys()
        cand_in = key
        if sorts:
            cand_in = torch.sort(key, dim=-1).values
        check(so.atpu_match_candidates(
            data.data_ptr(), cand_in.data_ptr(), best.data_ptr(), N, Bk,
            kw["depth"], kw["nw"], kw["nw_deep"], kw["max_off"], stream()),
            "match_candidates")
        runs()

    out = {"match_keys": keys, "match_candidates": cand, "match_runs": runs,
           "_find_matches": whole}
    if sorts:
        out["match_keys + torch.sort"] = keys_sorted
    return out, keys_sorted


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", default=[],
                    help="another source tree to time beside this one")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="also time this tree with one constant of "
                         "match_find.cu set anew")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_match_kernels: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}")
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    from aocl_compression_tpu_torch.ops import match_find as mf
    dev = torch.device("cuda")
    trees = ([("this tree", ROOT)] + [(d, d) for d in opts.src]
             + [(f"this tree, {v}", variant(v)) for v in opts.set])
    libs = {}
    for k, (label, tree) in enumerate(trees):
        libs[label], lines = build(tree, k)
        for ln in lines:
            print(f"[build] {label}: {ln}")
    times, bounds = {}, {}
    for label, (data, n, Bk), kw in inputs(dev):
        N = data.shape[0]
        want_key = ld._match_sorted_keys_plain(data, Bk, kw["hash_bits"])
        want = ld._find_matches(data, n, Bk, **kw)
        calls = {}
        for tree, _ in trees:
            shape = (N, Bk)
            bufs = [torch.empty(shape, dtype=torch.int32, device=dev)
                    for _ in range(5)] + [torch.empty(shape, dtype=torch.bool,
                                                      device=dev)]
            so = libs[tree]
            key = bufs[0]
            so.atpu_match_keys(data.data_ptr(), key.data_ptr(), N, Bk,
                               kw["hash_bits"],
                               torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            sorts = not torch.equal(key, want_key)
            stages, keys_sorted = paths(so, sorts, data, n, Bk, kw, bufs)
            keys_sorted()
            stages["match_candidates"]()
            stages["match_runs"]()
            torch.cuda.synchronize()
            if not torch.equal(bufs[1], want_key) or not all(
                    torch.equal(g, w) for g, w in zip(bufs[3:], want)):
                raise AssertionError(f"{tree} differs on {label}")
            if sorts:
                stages["torch.sort alone"] = lambda k=key: torch.sort(
                    k, dim=-1)
            calls[tree] = stages
        got = {}
        order = list(calls) + list(reversed(calls))
        for tree in order:
            for stage, fn in calls[tree].items():
                got.setdefault(tree, {}).setdefault(stage, []).append(
                    cs.graph_ms(fn))
        if N > 1:    # the scattered store pattern, beside a plain copy
            where = (want_key.long() & 0xFFFF) + torch.arange(
                N, device=dev)[:, None] * Bk
            where, vals = where.view(-1), want_key.view(-1)
            flat = torch.empty_like(vals)
            got["store pattern"] = {
                "scattered (index_copy_ at the sorted positions)":
                    [cs.graph_ms(lambda: flat.index_copy_(0, where, vals))],
                "in order (copy_)": [cs.graph_ms(lambda: flat.copy_(vals))]}
        times[label] = got
        nbytes = cs.match_bytes(N, Bk)
        bounds[label] = {k: v / cs.HBM_BYTES_PER_S * 1e3
                         for k, v in nbytes.items()}
        setting = ", ".join(f"{k} {v}" for k, v in kw.items())
        ctas = mf.runs_ctas(N, Bk, kw["small_offsets"], kw["nw"],
                            kw["ext_passes"])
        print(f"[match] {label} (N={N}, B={Bk}, {setting}; this tree's "
              f"match_runs: {ctas} CTA(s) a row)")
        for tree, stages in got.items():
            print(f"[match]   {tree}: " + "; ".join(
                f"{stage} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                for stage, ts in stages.items()))
        print(f"[match]   HBM bounds: " + "; ".join(
            f"{k} {v:.4f} ms" for k, v in bounds[label].items()))
    print(json.dumps({"card": smi, "times": times, "bounds": bounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
