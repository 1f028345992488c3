#!/usr/bin/env python3
"""Sweep the tuning constants of the port's compaction kernels
(aocl_compression_tpu_torch/csrc/compact.cu) on one card.

    python3 scripts/sweep_compact_consts.py

Each variant is the repository's compact.cu with some `constexpr int
kName = value;` lines replaced; all are built with nvcc at once into
aocl_compression_tpu_torch/_build/sweep/, bound like the repository's
build, and swapped in under ops/compact.py's wrapper, so every variant
runs the same launch sequence. Each is checked byte-equal to the plain
version, then timed by CUDA-graph replay in turns (variants in order,
then in reverse) at the main path's shape (N=256 chunks of 64 KiB, sizes
from a real encode of chip_smoke.py's corpus) and at N=16384 x 512,
N=65536 x 512 and N=16384 x 65536 with random sizes up to 1.5 OUTCAP.
Prints one JSON line per shape.
"""

import concurrent.futures
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import corpus, graph_ms  # noqa: E402

VARIANTS = {
    "repo": {},
    "s3a1": {"kStages": 3, "kAhead": 1},
    "s3a2": {"kStages": 3, "kAhead": 2},
    "s4a2": {"kStages": 4, "kAhead": 2},
    "s4a3": {"kStages": 4, "kAhead": 3},
    "slab64": {"kSlabRows": 64},
    "slab16_s4a2": {"kSlabRows": 16, "kStages": 4, "kAhead": 2},
}


def build_variant(compact, name, consts):
    from torch.utils.cpp_extension import CUDA_HOME
    src = open(compact._SRC).read()
    for k, v in consts.items():
        src, n = re.subn(rf"(constexpr int {k} = )\d+;", rf"\g<1>{v};", src)
        if n != 1:
            raise ValueError(f"no constant {k} in compact.cu")
    out = os.path.join(compact._BUILD, "sweep")
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, f"{name}.cu")
    so = os.path.join(out, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so, cu],
                   check=True)
    return compact.bind(so)


def time_shape(compact, libs, label, bodies, sizes):
    pd, pmeta = compact.compact_rows_plain(bodies, sizes)
    u = int(pmeta[0])
    for name, lib in libs.items():
        compact._lib = lib
        kd, kmeta = compact.compact_rows_kernel(bodies, sizes)
        torch.cuda.synchronize()
        if not (torch.equal(kmeta, pmeta) and torch.equal(kd[:u], pd[:u])):
            raise AssertionError(f"{name} differs from plain ({label})")
    del pd
    res = {k: [] for k in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            compact._lib = libs[name]
            res[name].append(graph_ms(
                lambda: compact.compact_rows_kernel(bodies, sizes)))
    print(json.dumps({"shape": label, "N": bodies.shape[0],
                      "OUTCAP": bodies.shape[1], "used_rows": u,
                      "graph_ms": res}))


def main():
    if not torch.cuda.is_available():
        print("sweep_compact_consts: no CUDA device", file=sys.stderr)
        return 1
    from aocl_compression_tpu_torch.ops import compact, lz4_device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as ex:
        futs = {k: ex.submit(build_variant, compact, k, v)
                for k, v in VARIANTS.items()}
        libs = {k: f.result() for k, f in futs.items()}
    dev = torch.device("cuda")

    B, N = 65536, 256
    data = corpus(B * N)
    arr = torch.from_numpy(
        np.frombuffer(data, dtype=np.uint8).reshape(N, B).copy()).to(dev)
    lens = torch.full((N,), B, dtype=torch.int32, device=dev)
    out, sizes, _, _ = lz4_device.make_encoder(B, 4)(arr, lens)
    time_shape(compact, libs, "main path encode", out, sizes)
    del arr, out

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rng = np.random.default_rng(7)
    for n, outcap in ((16384, 512), (65536, 512), (16384, 65536)):
        bodies = torch.randint(0, 256, (n, outcap), dtype=torch.uint8,
                               device=dev, generator=gen)
        sz = torch.from_numpy(rng.integers(0, outcap * 3 // 2 + 1, n)
                              .astype(np.int32)).to(dev)
        time_shape(compact, libs, f"random sizes {n}x{outcap}", bodies, sz)
        del bodies
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
