"""dryrun_multichip: one run of the multi-device tier's three levels at
tiny shapes, the port of the JAX package's multi-chip dry run
(__graft_entry__.dryrun_multichip):

  1. the full step (sharded.make_step) on a 1-D mesh of n shards;
  2. at n >= 2, the distributed encode over a 2 x n/2 ("hosts", "chips")
     mesh in one process;
  3. the unified API at num_shards = n, whose audit must name
     lz4_compress_blocks_multi and whose stream must round-trip.

Each prints one OK line; a failed check raises.
"""

from __future__ import annotations

import os

import numpy as np

from . import distributed, sharded


def _example_blocks(n_blocks: int, block_size: int, seed: int = 0):
    """(blocks (n, B) uint8, lens (n,) int32) of words from a seed."""
    rng = np.random.default_rng(seed)
    words = [b"the ", b"compression ", b"of ", b"data ", b"blocks ",
             b"hash ", b"match ", b"stream "]
    out = bytearray()
    while len(out) < n_blocks * block_size:
        out += words[rng.integers(0, len(words))]
    arr = np.frombuffer(bytes(out[:n_blocks * block_size]),
                        dtype=np.uint8).reshape(n_blocks, block_size).copy()
    return arr, np.full(n_blocks, block_size, dtype=np.int32)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device=None, devices=None) -> None:
    """Run the three levels on n_devices shards of `device` (None means
    cuda; the CPU offers virtual shards) or of an explicit `devices` list
    (several shards on one card: devices=[dev] * n)."""
    from ..api import unified as act
    from ..utils import dispatch

    mesh = sharded.make_mesh(n_devices, device, devices)
    B = 1024
    N = n_devices * 2
    arr, lens = _example_blocks(N, B)
    bodies, sizes, tails, total_bytes, total_in = sharded.make_step(
        B, mesh)(arr, lens)
    _check(sizes.shape == (N,) and tails.shape == (N,), "table shapes")
    _check(total_in == N * B, "total_in")
    _check(total_bytes == int(sizes.sum()), "total_bytes")
    _check([len(b) for b in bodies] == sizes.tolist(), "body sizes")
    print(f"dryrun_multichip({n_devices}): {total_in} bytes -> "
          f"{total_bytes} bytes across {N} blocks on {mesh.size} devices: OK")

    if n_devices >= 2:
        hosts, chips = 2, n_devices // 2
        mesh2 = distributed.make_host_chip_mesh(hosts, chips, device,
                                                devices)
        blocks = [bytes(arr[i]) for i in range(N)]
        chunks, (szs, _), n_glob = distributed.compress_blocks_distributed(
            blocks, B, mesh2, accel=2)
        _check(n_glob == N and len(szs) == N, "global block count")
        _check(sum(len(c) for c in chunks) == int(szs.sum()), "chunk sizes")
        print(f"dryrun_multichip({n_devices}): hosts={hosts} x chips="
              f"{chips} distributed encode OK ({int(szs.sum())} bytes)")

    data = bytes(arr.reshape(-1))
    h = act.setup("lz4", num_shards=n_devices, opt_var=2, block_size=B,
                  device=mesh.devices[0])
    prev_cap = os.environ.pop("AOCL_ENABLE_INSTRUCTIONS", None)
    dispatch.enable_audit(True)
    try:
        c = act.compress(h, data)
        hits = dispatch.audit_hits()
    finally:
        dispatch.enable_audit(False)
        if prev_cap is not None:
            os.environ["AOCL_ENABLE_INSTRUCTIONS"] = prev_cap
    _check(act.decompress(h, c, len(data)) == data, "API round trip")
    _check("lz4_compress_blocks_multi" in hits, f"audit {hits}")
    act.destroy(h)
    print(f"dryrun_multichip({n_devices}): unified-API multi tier OK "
          f"(setup(num_shards={n_devices}) -> lz4_compress_blocks_multi)")
