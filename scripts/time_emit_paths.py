#!/usr/bin/env python3
"""The lz4 and snappy compress paths on one card, for several source trees
in turns in one call: the paths whose sort-emit serializer
(lz4_device._emit_sorted, snappy_device._emit_snappy_sorted) runs as the
kernels of csrc/emit_sorted.cu in this tree and as tensor ops with a
torch.sort a row before it.

    python3 scripts/time_emit_paths.py [--src DIR ...]

Each DIR is a checkout (or an unpacked archive of a commit) of the port
whose shared host library csrc/libaocl_tpu_host.so is built or copied in
(cp csrc/*.so DIR/csrc/; else it builds at first use); the current tree is
always timed, as "this tree". The trees run in turns, A B .. B A, each
turn a child process that imports aocl_compression_tpu_torch from its
tree (its kernels build into the tree's own _build/) and, on
chip_smoke.py's corpus (256 blocks of 64 KiB, seed 42), measures:
  - compress through setup("lz4", opt_var=2) and setup("snappy",
    opt_var=2): best of 3 on the host clock after a warm-up call, MB/s,
    the peak device memory of the 3 calls (max_memory_allocated after a
    reset) and the stream's sha256 (the trees must agree);
  - the bench config's encoder (make_encoder(B, 8, 5, 5, subm=64,
    lazy=1, ext_passes=5)) likewise, with its bodies' sha256;
  - the serializer alone on the main path's, snappy's and the bench
    config's real inputs (captured from one encode): its device time
    between CUDA events around one call (best of 5), by CUDA-graph replay
    where the tree has the kernels (the plain version's repeat_interleave
    may synchronise, which a capture refuses), and the peak memory of one
    call above the memory in use before it.
It prints one line a turn and, last, one JSON object with every figure
and the card's name and power limit.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import aocl_compression_tpu_torch as act
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    from aocl_compression_tpu_torch.ops import snappy_device as sd
    if not os.path.abspath(act.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {act.__file__}, not {root}'s package")
    kernels = importlib.util.find_spec(
        "aocl_compression_tpu_torch.ops.emit_sorted") is not None
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    B, N = cs.B, cs.N
    data = cs.corpus(B * N)
    mb = len(data) / 1e6
    dev = torch.device("cuda")
    arr = torch.from_numpy(np.frombuffer(data, np.uint8).reshape(N, B)
                           .copy()).to(dev)
    lens = torch.full((N,), B, dtype=torch.int32, device=dev)
    bench = ld.make_encoder(B, 8, 5, 5, subm=64, lazy=1, ext_passes=5)

    def bench_run():
        out, sizes, tails, flags = bench(arr, lens)
        torch.cuda.synchronize()
        return out, sizes

    def peak_of(fn):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, t = cs.best_s(fn, 3)
        torch.cuda.synchronize()
        return res, t, torch.cuda.max_memory_allocated() / 1e9

    res = {}
    for key, method in (("lz4", "lz4"), ("snappy", "snappy")):
        h = act.setup(method, opt_var=2, block_size=B)
        c, t, peak = peak_of(lambda: act.compress(h, data))
        res[key] = dict(compress_ms=t * 1e3, mb_s=mb / t, peak_gb=peak,
                        sha256=hashlib.sha256(c).hexdigest())
    (out, sizes), t, peak = peak_of(bench_run)
    sha = hashlib.sha256(b"".join(
        bytes(out[i, :int(sizes[i])].cpu().numpy())
        for i in range(N))).hexdigest()
    res["bench"] = dict(compress_ms=t * 1e3, mb_s=mb / t, peak_gb=peak,
                        sha256=sha)
    for key, mod, name, run in (
            ("lz4", ld, "_emit_sorted",
             lambda: ld.make_encoder(B, 4)(arr, lens)),
            ("snappy", sd, "_emit_snappy_sorted",
             lambda: sd.make_encoder(B, 4)(arr, lens)),
            ("bench", ld, "_emit_sorted", lambda: bench(arr, lens))):
        args = cs.capture(mod, name, run)[0]
        fn = getattr(mod, name)
        fn(*args)
        res[key]["emit_events_ms"] = min(
            cs.device_call_ms(lambda: fn(*args))[1] for _ in range(5))
        if kernels:
            res[key]["emit_graph_ms"] = cs.graph_ms(lambda: fn(*args))
        res[key]["emit_peak_mb"] = cs.peak_above(lambda: fn(*args)) / 1e6
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", nargs="*", default=[])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child(a.child)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_emit_paths: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    trees = [("this tree", HERE)] + [(d, os.path.abspath(d)) for d in a.src]
    runs = []
    for label, root in trees + trees[::-1]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root], check=True,
                             stdout=subprocess.PIPE, text=True).stdout
        r = json.loads(out.strip().splitlines()[-1])
        r["tree"] = label
        runs.append(r)
        print(f"[{label}] " + "; ".join(
            f"{k} compress {r[k]['compress_ms']:.2f} ms "
            f"({r[k]['mb_s']:.2f} MB/s), peak {r[k]['peak_gb']:.2f} GB, "
            f"emit {r[k]['emit_events_ms']:.4f} ms (events, one call"
            + (f"; graph replay {r[k]['emit_graph_ms']:.4f}"
               if "emit_graph_ms" in r[k] else "")
            + f"; peak of a call {r[k]['emit_peak_mb']:.1f} MB)"
            for k in ("lz4", "snappy", "bench")), flush=True)
    for key in ("lz4", "snappy", "bench"):
        if len({r[key]["sha256"] for r in runs}) != 1:
            raise AssertionError(f"{key}: the trees' outputs differ")
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
