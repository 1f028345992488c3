#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aocl_compression_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits
non-zero before the last line:
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build: nvcc for every CUDA source and the host C++ library, started
     together;
  3. every kernel against its plain PyTorch version at the main path's
     shapes (N=256 chunks of OUTCAP=65536, sizes from a real encode, plus
     the edge sizes 0 and OUTCAP), with kernel / plain / library times and
     the HBM bound;
  4. the main path: setup("lz4", opt_var=2, block_size=65536) compress and
     decompress of a 16.8 MB corpus, exact round trip, serial decode after
     skip_rap_frame, the dispatch audit and the kernels' launch counts, and
     per-stage device times of the same pipeline;
  5. the bench encoder config (G=8, depth 5, nw 5, subm 64, lazy 1,
     ext_passes 5) on the same corpus;
  6. one JSON line listing every ported kernel;
  7. last line: {"ok": true, "device": {...}}.
"""

import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np
import torch

B = 65536
N = 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published peak


def corpus(total: int, seed: int = 42) -> bytes:
    """Text-like words, repeated 64-byte records and a random tail (the
    recipe of bench.py's _corpus)."""
    rng = np.random.default_rng(seed)
    parts = []
    n = 0
    words = [b"the ", b"of ", b"compression ", b"data ", b"block ",
             b"match ", b"hash ", b"entropy ", b"stream ", b"window "]
    while n < total * 2 // 3:
        w = words[rng.integers(0, len(words))]
        parts.append(w)
        n += len(w)
    rec = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    while n < total * 11 // 12:
        parts.append(rec)
        n += len(rec)
    tail = rng.integers(0, 256, total - n + 16, dtype=np.uint8).tobytes()
    parts.append(tail)
    return b"".join(parts)[:total]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches, after 0.3 s of
    warm-up launches (an idle card's clocks ramp up under load)."""
    warm_end = time.perf_counter() + 0.3
    while time.perf_counter() < warm_end:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def best_s(fn, iters: int = 3):
    """(last result, best wall time in s) of fn() over iters calls."""
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return out, min(ts)


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print("[card] nvidia-smi --query-gpu=name,power.limit:")
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"[card] torch: {name}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return name


def phase_build():
    from aocl_compression_tpu_torch.ops import compact
    from aocl_compression_tpu_torch.runtime import native

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        nvcc = ex.submit(timed, compact.build)
        host = ex.submit(timed, native.get_lib)
        print(f"[build] nvcc csrc/compact.cu (sm_90a): {nvcc.result():.2f} s; "
              f"host library (make -C csrc): {host.result():.2f} s")


def phase_kernel(out, sizes):
    """compact_rows kernel against its plain version on the card."""
    from aocl_compression_tpu_torch.ops import compact
    rows = compact._rows_view(out)
    edge = sizes.clone()
    edge[0], edge[1], edge[-1] = 0, B, B
    result = None
    for label, sz_in in (("encode sizes", sizes), ("edge sizes", edge)):
        sz, offs, used = compact._layout(sz_in, B)
        plain = compact.compact_rows_plain(rows, offs, used)
        kern = compact.compact_rows_kernel(rows, offs, sz)
        torch.cuda.synchronize()
        u = int(used)
        pb = plain[:u].view(torch.uint8).to(torch.int32)
        kb = kern[:u].view(torch.uint8).to(torch.int32)
        err = int((pb - kb).abs().max()) if u else 0
        if err or not torch.equal(plain[:u], kern[:u]):
            raise AssertionError(f"compact_rows differs from its plain "
                                 f"version ({label}): max_abs_err {err}")
        print(f"[kernel] compact_rows vs plain ({label}): used rows {u}, "
              f"byte-equal on [0, {u * 512})")
        if result is None:
            # library yardstick: one index_select of the precomputed row map
            flat = rows.reshape(-1, compact.ROWW)
            r = torch.arange(u, device=out.device)
            owner = torch.searchsorted(offs.to(torch.int64), r,
                                       right=True) - 1
            row_map = owner * (B // 512) + (r - offs.to(torch.int64)[owner])
            lib = flat.index_select(0, row_map)
            if not torch.equal(lib, kern[:u]):
                raise AssertionError("index_select yardstick disagrees")
            kernel_ms = cuda_ms(
                lambda: compact.compact_rows_kernel(rows, offs, sz), 200)
            plain_ms = cuda_ms(
                lambda: compact.compact_rows_plain(rows, offs, used), 50)
            library_ms = cuda_ms(lambda: flat.index_select(0, row_map), 200)
            bound_ms = 2 * u * 512 / HBM_BYTES_PER_S * 1e3
            print(f"[kernel] compact_rows at N={N}, OUTCAP={B}: kernel_ms "
                  f"{kernel_ms:.4f}, plain_ms {plain_ms:.4f}, library_ms "
                  f"(index_select) {library_ms:.4f}, bound_ms {bound_ms:.4f} "
                  f"(2 x {u} rows x 512 B at 3.35 TB/s)")
            result = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, library_ms=library_ms)
    return result


def phase_main(data: bytes, blocks, arr, lens):
    import aocl_compression_tpu_torch as act
    from aocl_compression_tpu_torch.codecs import lz4_stitch
    from aocl_compression_tpu_torch.ops import compact, lz4_device
    from aocl_compression_tpu_torch.parallel import container
    from aocl_compression_tpu_torch.runtime import native
    from aocl_compression_tpu_torch.utils import dispatch

    mb = len(data) / 1e6
    h = act.setup("lz4", opt_var=2, block_size=B, measure_stats=True)
    act.compress(h, data)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    dispatch.enable_audit(True)
    compact.launches = 0
    c, c_s = best_s(lambda: act.compress(h, data))
    launches = {"compact_rows": compact.launches}
    hits = dispatch.audit_hits()
    dispatch.enable_audit(False)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[main] dispatch audit: {json.dumps(hits, sort_keys=True)}")
    print(f"[main] kernel launches during 3 compress calls: "
          f"{json.dumps(launches)}")
    if hits.get("lz4_compress_blocks_torch") != 3 \
            or hits.get("fetch_chunks_kernel") != 3:
        raise AssertionError("main path did not run the TORCH-tier encoder "
                             "and the KERNEL-tier compactor")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"kernel {name} was not launched")
    d, d_s = best_s(lambda: act.decompress(h, c))
    if d != data:
        raise AssertionError("decompress did not return the input")
    if native.lz4_decompress(container.skip_rap_frame(c), len(data)) != data:
        raise AssertionError("serial decode after skip_rap_frame failed")
    print(f"[main] setup('lz4', opt_var=2, block_size={B}) on "
          f"{h.device}: {len(data)} B -> {len(c)} B, ratio "
          f"{len(data) / len(c):.4f}; compress {mb / c_s:.2f} MB/s (best of "
          f"3, {c_s * 1e3:.2f} ms), decompress {mb / d_s:.2f} MB/s (best of "
          f"3); round trip exact, serial decode exact; peak device memory "
          f"{peak_gb:.2f} GB")

    # per-stage device times of the same pipeline (API default config)
    G = lz4_device.grid_for_accel(2)
    depth, nw, subm = 4, 8, 128
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    stage = {k: [] for k in ("find_matches", "grid_select", "emit_sorted",
                             "compaction", "d2h", "host_stitch_rap")}
    for _ in range(3):
        ev[0].record()
        mlen, moff, valid = lz4_device._find_matches(arr, lens, B,
                                                     depth=depth, nw=nw)
        ev[1].record()
        sel, cpos, cml, coff = lz4_device._grid_select(
            mlen, moff, valid, B, G, subm=subm,
            match_cap=lz4_device._match_cap(G, nw, subm, 0))
        ev[2].record()
        out, sizes, tails, flags = lz4_device._emit_sorted(
            arr, lens, sel, cpos, cml, coff, B, G)
        ev[3].record()
        dense, offs, used, sz = compact.compact_rows(out, sizes)
        ev[4].record()
        meta = torch.cat([used, offs, sz]).tolist()
        ev[5].record()
        buf = dense[:meta[0]].cpu().numpy().tobytes()
        ev[6].record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o, s = meta[1:N + 1], meta[N + 1:]
        bodies = [buf[o[i] * 512: o[i] * 512 + s[i]] for i in range(N)]
        chunks, dlens = lz4_stitch.stitch_bodies(bodies, tails.tolist(),
                                                 blocks)
        offsets = np.cumsum([0] + [len(x) for x in chunks[:-1]])
        frame = native.rap_write(N, offsets + native.rap_frame_len(N),
                                 [len(x) for x in chunks], dlens)
        stream = frame + b"".join(chunks)
        stage["host_stitch_rap"].append((time.perf_counter() - t0) * 1e3)
        for k, key in enumerate(("find_matches", "grid_select",
                                 "emit_sorted", "compaction")):
            stage[key].append(ev[k].elapsed_time(ev[k + 1]))
        stage["d2h"].append(ev[5].elapsed_time(ev[6]))
    if not flags.any() and stream != c:
        raise AssertionError("staged pipeline stream differs from the API's")
    print("[main] stage times, ms (min of 3; device events, host clock for "
          "the stitch): " + ", ".join(f"{k} {min(v):.3f}"
                                      for k, v in stage.items()))
    print(f"[main] flagged blocks (host re-encode): {int(flags.sum())}")
    return launches


def phase_bench(data: bytes, blocks, arr, lens):
    from aocl_compression_tpu_torch.codecs import lz4_stitch
    from aocl_compression_tpu_torch.ops import compact, lz4_device
    from aocl_compression_tpu_torch.runtime import native

    enc = lz4_device.make_encoder(B, 8, 5, 5, subm=64, lazy=1, ext_passes=5)

    def run():
        out, sizes, tails, flags = enc(arr, lens)
        return compact.fetch_chunks(out, sizes), tails, flags

    run()
    (bodies, tails, flags), t = best_s(run)
    tails = tails.tolist()
    for i in np.nonzero(flags.cpu().numpy())[0]:
        stream, tl = native.lz4_compress_tail(blocks[i], 3)
        bodies[i] = stream[:len(stream) - lz4_stitch.final_sequence_len(tl)]
        tails[i] = tl
    chunks, _ = lz4_stitch.stitch_bodies(bodies, tails, blocks)
    joined = b"".join(chunks)
    if native.lz4_decompress(joined, len(data)) != data:
        raise AssertionError("bench-config stream does not decode")
    print(f"[bench] make_encoder({B}, 8, 5, 5, subm=64, lazy=1, "
          f"ext_passes=5) + fetch_chunks: ratio {len(data) / len(joined):.4f},"
          f" {len(data) / 1e6 / t:.2f} MB/s (best of 3, {t * 1e3:.2f} ms); "
          f"stitched stream decodes exactly")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import aocl_compression_tpu_torch  # noqa: F401  (fails outside the repo)
    from aocl_compression_tpu_torch.ops import lz4_device

    name = phase_card()
    phase_build()

    data = corpus(B * N)
    blocks = [data[i * B:(i + 1) * B] for i in range(N)]
    dev = torch.device("cuda")
    arr = torch.from_numpy(
        np.frombuffer(data, dtype=np.uint8).reshape(N, B).copy()).to(dev)
    lens = torch.full((N,), B, dtype=torch.int32, device=dev)

    # a real encode at the main path's config gives the kernel its sizes
    out, sizes, _, _ = lz4_device.make_encoder(B, 4)(arr, lens)
    kernel = phase_kernel(out, sizes)
    launches = phase_main(data, blocks, arr, lens)
    phase_bench(data, blocks, arr, lens)

    kernels = [dict(name="compact_rows", route="cuda",
                    source="aocl_compression_tpu_torch/csrc/compact.cu",
                    replaces="aocl_compression_tpu/ops/compact.py:47",
                    launches=launches["compact_rows"], bound_by="bytes",
                    **kernel)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
