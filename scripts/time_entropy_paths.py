#!/usr/bin/env python3
"""zlib level 2 and zstd level 1 compress on one card, for several source
trees in turns in one call: the two paths whose entropy tables
(deflate_device._kraft_lengths, zstd_device._block_huffman and
_encode_weights) run through the kernels of csrc/entropy_scan.cu in this
tree and through loops of tensor ops before it.

    python3 scripts/time_entropy_paths.py [--src DIR ...]

Each DIR is a checkout (or an unpacked archive of a commit) of the port
whose shared host library csrc/libaocl_tpu_host.so is built (or builds at
first use); the current tree is always timed, as "this tree". The trees
run in turns, A B .. B A, each turn a child process that imports
aocl_compression_tpu_torch from its tree (its kernels build into the
tree's own _build/) and, on chip_smoke.py's corpus (256 blocks of 64 KiB,
seed 42), times on the host clock after a warm-up call:
  - compress through setup("zlib", level=2, opt_var=2) and
    setup("zstd", level=1, opt_var=2), best of 3, with each stream's
    sha256 (the trees must agree);
  - each encoder's compress_blocks at the single-device tier and on four
    virtual shards of the card (the MULTI variant, devices=[cuda] * 4),
    best of 3 each;
  - the stage functions on the batch's own inputs, with a synchronise,
    best of 5: _kraft_lengths at 288 and 32 symbols (the zlib-2 encoder's
    two calls), and _block_huffman followed by _encode_weights (zstd 1).
It prints one line a turn and, last, one JSON object with every time and
the card's name and power limit.
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
    from aocl_compression_tpu_torch.ops import deflate_device as dd
    from aocl_compression_tpu_torch.ops import zstd_device as zd
    from aocl_compression_tpu_torch.utils import dispatch
    from aocl_compression_tpu_torch.utils.config import TIER_MULTI, TIER_TORCH
    if not os.path.abspath(act.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {act.__file__}, not {root}'s package")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    B, N = cs.B, cs.N
    data = cs.corpus(B * N)
    blocks = [data[i * B:(i + 1) * B] for i in range(N)]
    dev = torch.device("cuda")
    res = {}
    for key, method, kw, args in (
            ("zlib2", "zlib", dict(level=2), (blocks, 2, dev)),
            ("zstd1", "zstd", dict(level=1), (blocks, 1, None, dev))):
        h = act.setup(method, opt_var=2, block_size=B, **kw)
        act.compress(h, data)
        c, t = cs.best_s(lambda: act.compress(h, data), 3)
        res[key] = dict(compress_ms=t * 1e3,
                        sha256=hashlib.sha256(c).hexdigest())
        single = dispatch.resolve(method, "compress_blocks", TIER_TORCH)
        multi = dispatch.resolve(method, "compress_blocks", TIER_MULTI)
        for tier, fn in (("single_ms", lambda: single(*args)),
                         ("multi4_ms", lambda: multi(
                             *args, num_shards=4, devices=[dev] * 4))):
            fn()
            res[key][tier] = cs.best_s(fn, 3)[1] * 1e3
    arr = torch.from_numpy(np.frombuffer(data, np.uint8).reshape(N, B)
                           .copy()).to(dev)
    lens = torch.full((N,), B, dtype=torch.int32, device=dev)
    h288, h32 = cs.capture(dd, "_kraft_lengths",
                           lambda: dd.make_encoder_dyn(B, 4)(arr, lens))

    def kraft():
        return dd._kraft_lengths(*h288), dd._kraft_lengths(*h32)

    (hargs,) = cs.capture(zd, "_block_huffman",
                          lambda: zd.make_encoder(B, 4)(arr, lens))

    def huffman():
        return zd._encode_weights(zd._block_huffman(*hargs)[2])

    for name, fn in (("kraft_lengths_ms", kraft), ("huffman_ms", huffman)):
        fn()
        res[name] = cs.wall_ms(fn, 5)
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
        print("time_entropy_paths: no CUDA device", file=sys.stderr)
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
                             capture_output=True, text=True).stdout
        r = json.loads(out.strip().splitlines()[-1])
        r["tree"] = label
        runs.append(r)
        print(f"[{label}] zlib 2 compress {r['zlib2']['compress_ms']:.2f} ms"
              f" (single {r['zlib2']['single_ms']:.2f}, 4 virtual shards "
              f"{r['zlib2']['multi4_ms']:.2f}); zstd 1 compress "
              f"{r['zstd1']['compress_ms']:.2f} ms (single "
              f"{r['zstd1']['single_ms']:.2f}, 4 virtual shards "
              f"{r['zstd1']['multi4_ms']:.2f}); _kraft_lengths 288 + 32 "
              f"{r['kraft_lengths_ms']:.3f} ms; _block_huffman + "
              f"_encode_weights {r['huffman_ms']:.3f} ms")
    for key in ("zlib2", "zstd1"):
        if len({r[key]["sha256"] for r in runs}) != 1:
            raise AssertionError(f"{key}: the trees' streams differ")
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
