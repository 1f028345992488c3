#!/usr/bin/env python3
"""Operator-level profile of the port's LZ4 device encode on one GPU.

Runs the main path's encoder (make_encoder(65536, 4): G=4, depth 4, nw 8)
plus fetch_chunks on the chip_smoke.py corpus (256 x 64 KiB) under
torch.profiler and prints, per iteration: wall time, device busy time (the
sum of the device time of all operators) and the device's idle share, then
the operators with the most device time.

    python3 scripts/profile_torch_encode.py [iterations]
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import B, N, corpus  # noqa: E402
from aocl_compression_tpu_torch.ops import compact, lz4_device  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    data = corpus(B * N)
    arr = torch.from_numpy(
        np.frombuffer(data, dtype=np.uint8).reshape(N, B).copy()).cuda()
    lens = torch.full((N,), B, dtype=torch.int32, device="cuda")
    enc = lz4_device.make_encoder(B, 4)

    def run():
        out, sizes, tails, flags = enc(arr, lens)
        return compact.fetch_chunks(out, sizes), tails.tolist()

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # device-side events (kernels, copies, memsets) give the busy time;
    # host-side operators carry the device time of the kernels they launch
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == cuda) / 1e3 / iters
    print(f"per iteration: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, device idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.4f}")
    ops = sorted((e for e in events if e.device_type != cuda),
                 key=lambda e: -e.self_device_time_total)
    print(f"{'operator':40s} {'calls/iter':>10s} {'device ms/iter':>15s} "
          f"{'share':>7s}")
    for e in ops[:20]:
        if not e.self_device_time_total:
            break
        ms = e.self_device_time_total / 1e3 / iters
        print(f"{e.key[:40]:40s} {e.count / iters:10.1f} {ms:15.3f} "
              f"{ms / busy_ms:7.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
