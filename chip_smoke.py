#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aocl_compression_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits
non-zero before the last line:
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build: nvcc for every CUDA source (compact.cu, zstd_scan.cu,
     inflate_scan.cu, entropy_scan.cu, chain_scan.cu, match_find.cu,
     emit_sorted.cu) and the host C++ library, started together (ptxas's registers and shared
     memory of every kernel);
  3. every kernel against its plain PyTorch version, output for output:
     compact_rows (layout scan + bulk copy) at the main path's shapes
     (N=256 chunks of OUTCAP=65536, sizes from a real encode), at every
     other path's rows with sizes from a real encode (lz4hc level 9: 66048
     = 129 rows of 512 B; snappy G=4: 65536; snappy G=0: 76800 = 150 rows;
     static deflate: 74240 = 145 rows; the dynamic deflate bodies at the
     sizes its fetch reads: 74240), at the decoder's full rows (N=256 x
     65536, every row used), at edge sizes (0, OUTCAP, > OUTCAP) and at
     N=16384 x OUTCAP=512 with random sizes; a profiler window showing that
     one call runs only the port's two kernels; kernel / plain / library
     times (device time from CUDA-graph replay) at the main path's shape,
     kernel / library times at the other shapes, each beside its HBM
     bound, and the pinned d2h of the used rows beside its measured
     link-rate bound;
  4. the main path: setup("lz4", opt_var=2, block_size=65536) compress and
     decompress of a 16.8 MB corpus, exact round trip, serial decode after
     skip_rap_frame, the dispatch audit and the kernels' launch counts, and
     per-stage device times of the same pipeline, the compaction and d2h
     taken inside the API's own fetch; the kernel subchain_reach
     (csrc/chain_scan.cu) against its plain version on the encode's real
     input, its graph-replay time, HBM bound, longest lane's steps, µs and
     SM cycles per step and serial floor; a profiler window over one
     _grid_select call (no bmm or gemm) and the peak memory of one
     _reach_from_start call above the memory in use before it; the match
     kernels (csrc/match_find.cu: match_keys, match_candidates,
     match_runs), launched once a compress call each, against the plain
     _find_matches on the path's real call (check_matches: the whole
     function output for output, each kernel on the kernel path's own
     inputs, match_keys' sorted keys exactly; graph-replay times of each
     kernel, of torch.sort of the unsorted keys (match_keys' library
     yardstick) and of the whole kernel path beside the plain versions'
     times and the HBM bounds; the peak memory of one call of each path)
     and on seeded adversarial rows at every encoder's setting and four
     more (match_adversarial, B = 256 and 4,096); match_runs alone on
     seeded rows whose runs and ladder chains cross its CTAs' slices at N
     = 1, 2, 3, 5 and 64 rows of 65,536 and 1, 9 and 17 of 4,096, with
     the CTAs a row it picks at each (runs_adversarial); the kernel
     emit_lz4 (csrc/emit_sorted.cu), launched once a compress call,
     against the plain _emit_sorted on the path's real call (check_emit:
     out, body, tail and flag equal; its graph-replay time, the plain
     version's, the HBM bound, the peak memory of one call of each), then
     emit_lz4 and emit_snappy on seeded rows (emit_rows at B = 65,536 and
     4,096 through the tile parse at G = 2, 4 and 8: flagged rows, a row
     whose lz4 body runs past B, all-literal, all-equal and padded rows)
     and on seeded irregular parses with colliding output positions
     (emit_adversarial);
  5. the bench encoder config (G=8, depth 5, nw 5, subm 64, lazy 1,
     ext_passes 5) on the same corpus, its kernels' launches in 3 calls,
     and subchain_reach against its plain version on its real input (SUBM
     64); the match kernels on its real call as in phase 4 (the
     saturated-match ladder runs here), emit_lz4 likewise;
  6. lz4hc: setup("lz4hc", opt_var=2, block_size=65536) at the default
     level 9 (the exact-parse encoder, G=0) on the same corpus: audit,
     launches, exact round trip, serial decode after skip_rap_frame, ratio
     beside the host tier's at level 9, compress MB/s, peak memory and
     per-stage device times; the launches of one _greedy_parse call on
     the kernel path and of one call of the plain _chain_marks_plain; the
     kernel chain_marks against its plain version on the real input, with
     its times, bound, steps and serial floor as in phase 4, a profiler
     window over one _greedy_parse call (no bmm or gemm) and the peak
     memory of one _chain_marks call; the match kernels on the real call
     (depth 11, nw 32) as in phase 4; both chain kernels against their
     plain versions on seeded adversarial rows (exits
     back into earlier or the same segment, in-segment back and self edges
     and cycles, targets below 0 and past C, exits at C, clen 0 and not a
     multiple of 128);
  7. device decode (set_config(device_decode=True)) of the lz4 and lz4hc
     streams: exact, audited, MB/s beside the host decoder's, peak memory,
     the chunks on each route, resolve passes and per-stage device times;
     chain_marks against its plain version on the lz4hc batch's real
     input;
  8. snappy: setup("snappy", opt_var=2) on the same corpus (3 calls):
     audit, launches, ratio and MB/s beside the host tier's, peak memory,
     host round trip, serial snappy_uncompress after skip_rap_frame, the
     16-block stream's sha256 against the JAX package's, per-stage device
     times, the match kernels on the real call as in phase 4, the kernel
     emit_snappy (launched once a compress call) on the real call as
     emit_lz4 in phase 4; then device decode of the stream through the
     API (exact,
     audited, launches per batch, MB/s beside the host decoder's) and its
     stage times; chain_marks against its plain version on the decode
     batch's real input;
  9. zlib: setup("zlib", level=1|2, opt_var=2) likewise (the match
     kernels on level 1's real call, max_off 32768, as in phase 4), each
     stream read by stdlib zlib.decompress after skip_rap_frame, the host
     deflate at
     levels 1 and 6 timed on the same corpus, the kraft_absorb kernel's
     launches in the level-2 calls, and the launches and device time of
     the dynamic path's two _kraft_lengths calls (the kernel path); the
     kernel kraft_absorb (csrc/entropy_scan.cu) against its plain loop on
     the whole batch's real 288- and 32-symbol inputs and on seeded
     adversarial rows (no symbol, one, all present, all-equal counts, a
     65,536-count symbol whose share wraps negative, two 70,000-count
     symbols, a Kraft sum past 1) and on a seeded batch called directly
     (unsorted lengths, arbitrary int32 deficits), its graph-replay time,
     HBM bound, serial steps of the run walk (the longest row's runs plus
     its steps that change a length), µs and SM cycles per step, serial
     floor and SM cycles a warp of each phase (staging, runs, walk,
     write-back; scripts/entropy_phases.py's stamped build); then device
     inflate
     (set_config(device_decode=True)) of both streams through the API:
     exact, audited, the inflate kernel's launches, the chunks on each
     route (card, planner reject, multi-block), lanes per launch, MB/s
     beside the host decoder's, peak memory and per-stage device times;
     then the kernel inflate_symbol_scan (csrc/inflate_scan.cu) against
     its plain version on the first 8 lanes of the batch's real inputs
     and on a seeded adversarial batch of 8 lanes, its graph-replay time
     on the whole batch, its HBM bound, its longest lane's serial steps,
     µs and SM cycles per step (the clock read by nvidia-smi while it
     runs) and the serial floor (FLOOR_CYCLES_PER_STEP a step);
 10. zstd: setup("zstd", level=1, opt_var=2) on the same corpus (3
     calls): audit, the compaction's, the FSE scan kernel's and the two
     entropy-table kernels' (kraft_absorb, weights_fse_encode) launches,
     ratio and MB/s beside the host tier's at level 1, peak memory, the
     16-block stream's sha256 against the JAX package's, per-stage device
     times, the match kernels on the real call (depth 8) as in phase 4;
     device decode through the API (exact, audited, the two decode
     scan kernels' launches, MB/s beside the host decoder's, frames on each
     route) and its stage times; then each of the three scan kernels of
     csrc/zstd_scan.cu against its plain loop on the first 16 blocks of the
     batch's real inputs, its graph-replay time on the whole batch, its HBM
     bound, its longest lane's serial steps, µs and SM cycles per step
     and the serial floor; each of the three also on a seeded adversarial
     batch made from those 16 blocks (corrupt streams and sections, edge
     counts and lengths, codes, table logs and table values outside their
     ranges; phase 3 holds the compaction at the zstd shapes 1,024 x
     23,040 and 256 x 82,432); kraft_absorb at 256 symbols and
     weights_fse_encode against their plain loops on the whole batch's
     real inputs and on seeded adversarial rows (literal rows with no
     literal, one, one symbol, all 256, 64 equal counts, a Kraft sum past
     1; weights all 0, all 11, alternating, a ramp, random), with their
     times, bounds, serial floors and phase cycles as in phase 9 (the
     weight encode's longest lane: 128 steps; its time includes the
     caller's contiguous copy of the weights view);
 11. bzip2 and lzma on the same corpus: setup("bzip2", level=9) (host)
     beside setup("bzip2", level=9, opt_var=2) (the device block sort),
     setup("lzma", level=6) (host) beside setup("lzma", level=6,
     opt_var=2) (the device match-finder assist): audit, ratio, MB/s (one
     call each: the host lzma and the device tiers take seconds), round
     trips through the API and stdlib bz2 / lzma, peak memory, the
     16-block stream's sha256 against the JAX package's, the match kernels
     on the lzma assist's real call (depth 16) as in phase 4, and stage
     times
     (the BWT on the card against bz2_prepare / bz2_emit on the host;
     _find_matches and _grid_parse at G = 1 against lzma_compress_cand);
 12. the host surface on the card, on the same corpus: the LZ4 frame at
     the device tier (compress_frame(max_tier=TIER_TORCH, device="cuda"):
     one device call and one compact_rows per 64 KiB frame block; the
     first 16 blocks with block checksums off and on, audited, launches
     counted, round trips through decompress_frame and DecompressStream,
     their sha256 against the JAX package's, MB/s best of 3; the
     compaction and chain_marks at the frame path's shape (N = 1 block;
     chain_marks at N = 1 x 65,536, where most of its launches run)
     against their plain versions, chain_marks with its graph-replay
     time, HBM bound and serial floor, the match kernels at the same
     shape as in phase 4; the whole corpus timed once beside
     the host-tier frame and
     phase 4's RAP path), native_api.LZ4_compress_fast(data, 2) (equal to
     setup("lz4", opt_var=2, enable_rap=False), decoded by
     LZ4_decompress_safe, pinned), CompressStream / DecompressStream of
     every stream codec (stdlib zlib, gzip and bz2 read theirs), .xz at 1
     MiB blocks (stdlib lzma, random access to one block), a trained zstd
     dictionary through the API, the bench CLI (-e lz4:0:2 on the card,
     every JSON line verified; one -n run) and profiling.trace around one
     device compress (the span and both compaction kernels in the trace);
 13. the multi-device tier (parallel/sharded.py, parallel/distributed.py)
     at world size 1 on the same corpus: setup("lz4", opt_var=2,
     num_shards=4) (audit lz4_compress_blocks_multi, one shard a card,
     phase 4's stream); sharded.compress_blocks_multi on four virtual
     shards of the card (bodies and tails equal phase 4's, two compact_rows
     launches a shard, MB/s and peak memory beside the single-device tier
     in turns; the match kernels and emit_lz4 on a shard's real call, N =
     64, as in phase 4); snappy, zlib 1 and 2 and zstd 1 through their
     *_multi variants on four virtual shards (each stream equal to its
     phase's, MB/s beside the single-device variant in turns,
     fse_encode_scan, kraft_absorb and weights_fse_encode once a zstd
     shard, kraft_absorb twice a zlib-2 shard; emit_snappy on a snappy
     shard's real call); the lz4 MULTI decoder on four virtual shards
     (exact, MB/s likewise); compress_blocks_distributed in a single-rank
     NCCL group over a 1 x 4 host-chip mesh (tables and totals equal
     phase 4's); dryrun_multichip(4) on four virtual shards;
 14. one JSON line listing every ported kernel: compact_rows with its
     launches summed over the paths of phases 4, 6-10, 12 and 13, the zstd
     scan kernels with theirs in phases 10 and 13, inflate_symbol_scan with
     its own in phase 9, kraft_absorb with its launches in phases 9, 10
     and 13 (its times at zlib 2's 288-symbol call), weights_fse_encode
     with its own in phases 10 and 13, subchain_reach (its times at the
     main path's input) and chain_marks (at lz4hc 9's), the three match
     kernels (at the main path's call) and the two emit kernels (emit_lz4
     at the main path's call, emit_snappy at snappy's), with their
     launches summed over every path driven with the counts set to 0;
 15. last line: {"ok": true, "device": {...}}.
"""

import concurrent.futures
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

B = 65536
N = 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published peak
ROOT = os.path.dirname(os.path.abspath(__file__))

#: the instrumented build of csrc/entropy_scan.cu (scripts/
#: entropy_phases.py): "lib" -> (ctypes library, {kernel: phase names})
ENTROPY_PHASES = {}

# The new paths' calls, and the sha256 of the JAX package's RAP stream of
# the corpus's first PINNED_BLOCKS blocks under each, computed with JAX on
# the CPU (tests/test_torch_pinned.py holds them to the JAX package); the
# port's stream on the card must match.
PINNED_BLOCKS = 16
PINNED_CALLS = {
    "snappy": ("snappy", dict(opt_var=2)),
    "zlib level 1": ("zlib", dict(level=1, opt_var=2)),
    "zlib level 2": ("zlib", dict(level=2, opt_var=2)),
    "zstd level 1": ("zstd", dict(level=1, opt_var=2)),
    "bzip2 level 9": ("bzip2", dict(level=9, opt_var=2)),
    "lzma level 6": ("lzma", dict(level=6, opt_var=2)),
}
PINNED_SHA256 = {
    "snappy":
        "591c958f9e08f6a4e4d8c111ea34d19d3daf54cd0366486ad4648129a3b69a7b",
    "zlib level 1":
        "51ef226de55f3aeb726ac0b60eed46d896a4723cd7bce433bbe8f079435e6b8c",
    "zlib level 2":
        "42f3edfe137731687ee84e4b661ad771d74d8699b34f26f5ac0460f6826d9a38",
    "zstd level 1":
        "f3389678928ff557b7981e31ab70e22573106ca4b71e3fa0a811ce6c851bcb99",
    # the first 16 blocks (1 MiB) as for the others: one 900,000-byte
    # BWT block and a short one; 16 lzma assist blocks
    "bzip2 level 9":
        "7e275b024219289ffa89e6ff12d11c9ae7b2b3c5869f826d2d0aee0d17869afd",
    "lzma level 6":
        "7714dcaebebd8a3b1452d36f4e207835735cf71925f8bcdd5b343cc2249e5cde",
}


# The host surface's device-tier calls on the same first PINNED_BLOCKS
# blocks (phase 12), against the JAX package's bytes at its device tier
# (JAX on the CPU; tests/test_torch_pinned.py holds them):
# lz4_frame.compress_frame(data, max_tier=<device tier>) and
# native_api.LZ4_compress_fast(data, 2).
PINNED_SURFACE_SHA256 = {
    "lz4 frame":
        "bd814dcf812ccb60a589928f9b48668e72f2d3c7dcc4f006d15fd2e2466c7a7a",
    "LZ4_compress_fast":
        "60f8e9401add97c3373f20e27da965c7202ec69d8730dad70d97c6858096dcda",
}


# The API's stream of the corpus from phases 4 and 8-10, which phase 13
# holds the multi-device tier to: "lz4", "snappy", "zlib level 1",
# "zlib level 2", "zstd level 1".
STREAMS = {}


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
    warm-up launches (an idle card's clocks ramp up under load; at most 8
    of them in flight, so a call of milliseconds does not queue minutes of
    warm-up behind the host's loop)."""
    warm_end = time.perf_counter() + 0.3
    flight = []
    while time.perf_counter() < warm_end:
        fn()
        flight.append(torch.cuda.Event())
        flight[-1].record()
        if len(flight) > 8:
            flight.pop(0).synchronize()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def wall_ms(fn, iters: int = 20) -> float:
    """Best host-clock time of fn() followed by a device synchronise."""
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return min(ts) * 1e3


def best_s(fn, iters: int = 3):
    """(last result, best wall time in s) of fn() over iters calls."""
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return out, min(ts)


def device_call_ms(fn):
    """(result, device ms) of one fn() call by CUDA events."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def peak_above(fn):
    """Peak device memory (bytes) of one fn() call above the memory in use
    before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


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
    from aocl_compression_tpu_torch.ops import (chain_scan, compact,
                                                emit_sorted, entropy_scan,
                                                inflate_scan, match_find,
                                                zstd_scan)
    from aocl_compression_tpu_torch.runtime import native

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import entropy_phases

    def phases():
        ENTROPY_PHASES["lib"] = entropy_phases.build(ROOT)

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        nvcc = ex.submit(timed, compact.build)
        scan = ex.submit(timed, zstd_scan.build)
        inf = ex.submit(timed, inflate_scan.build)
        ent = ex.submit(timed, entropy_scan.build)
        stamped = ex.submit(timed, phases)
        chain = ex.submit(timed, chain_scan.build)
        match = ex.submit(timed, match_find.build)
        emit = ex.submit(timed, emit_sorted.build)
        host = ex.submit(timed, native.get_lib)
        print(f"[build] nvcc csrc/compact.cu (sm_90a): {nvcc.result():.2f} s; "
              f"nvcc csrc/zstd_scan.cu (sm_90a): {scan.result():.2f} s; "
              f"nvcc csrc/inflate_scan.cu (sm_90a): {inf.result():.2f} s; "
              f"nvcc csrc/entropy_scan.cu (sm_90a): {ent.result():.2f} s "
              f"(its copy with phase stamps, scripts/entropy_phases.py: "
              f"{stamped.result():.2f} s); "
              f"nvcc csrc/chain_scan.cu (sm_90a): {chain.result():.2f} s; "
              f"nvcc csrc/match_find.cu (sm_90a): {match.result():.2f} s; "
              f"nvcc csrc/emit_sorted.cu (sm_90a): {emit.result():.2f} s; "
              f"host library (make -C csrc): {host.result():.2f} s")
    for log in (compact.build_log, zstd_scan.build_log,
                inflate_scan.build_log, entropy_scan.build_log,
                chain_scan.build_log, match_find.build_log,
                emit_sorted.build_log):
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"[build] {line.strip()}")


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time of one fn() call: reps calls captured in a CUDA graph,
    replayed back to back (no host launch overhead between calls), after
    a warm-up as in cuda_ms."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return cuda_ms(g.replay, replays) / reps


# Model of a serial scan's floor on this card: one dependent shared-memory
# load per step (about 30 SM cycles of latency on Hopper), nothing else.
FLOOR_CYCLES_PER_STEP = 30


def sm_clock_mhz(fn) -> float:
    """The SM clock (MHz) nvidia-smi reads while fn() runs back to back."""
    p = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         stdout=subprocess.PIPE, text=True)
    while p.poll() is None:
        fn()
        torch.cuda.synchronize()
    return float(p.communicate()[0].split()[0])


def per_step(tag, name, fn, ms, steps):
    """µs and SM cycles per serial step of the longest lane, beside the
    serial floor (FLOOR_CYCLES_PER_STEP per step at the clock read while
    fn() runs); returns dict(us_per_step, cycles_per_step, floor_ms,
    mhz)."""
    mhz = sm_clock_mhz(fn)
    us = ms / steps * 1e3
    floor_ms = steps * FLOOR_CYCLES_PER_STEP / mhz / 1e3
    print(f"[{tag}] {name}: {us:.4f} us per step, {us * mhz:.1f} SM "
          f"cycles per step at {mhz:.0f} MHz (nvidia-smi clocks.sm while "
          f"it runs); "
          f"serial floor {floor_ms:.4f} ms ({steps} steps x "
          f"{FLOOR_CYCLES_PER_STEP} cycles)")
    return dict(us_per_step=us, cycles_per_step=us * mhz, floor_ms=floor_ms,
                mhz=mhz)


def check_equal(label, got, want):
    """Every output of a kernel equal to its plain version's; returns the
    max abs error (0)."""
    err = max_err(got, want)
    if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{label} differs from its plain version: "
                             f"max_abs_err {err}")
    return err


def check_compact(compact, label, bodies, sizes):
    """The kernels against the plain version, output for output
    (dense[:used] and meta = [used, row_offs, sz]); returns (used rows,
    max abs byte error)."""
    pd, pmeta = compact.compact_rows_plain(bodies, sizes)
    u = int(pmeta[0])
    kd, kmeta = compact.compact_rows_kernel(bodies, sizes)
    torch.cuda.synchronize()
    err = 0
    for p, k in ((pmeta, kmeta), (pd[:u], kd[:u])):
        if p.numel():
            err = max(err, int((p.view(torch.uint8).to(torch.int32)
                                - k.view(torch.uint8).to(torch.int32))
                               .abs().max()))
    if err or not (torch.equal(pmeta, kmeta) and torch.equal(pd[:u], kd[:u])):
        raise AssertionError(f"compact_rows differs from its plain version "
                             f"({label}): max_abs_err {err}")
    print(f"[kernel] compact_rows vs plain ({label}): N={bodies.shape[0]}, "
          f"OUTCAP={bodies.shape[1]}, used rows {u}; byte-equal on "
          f"dense[:used] and meta")
    return u, err


def yardstick(compact, bodies, sizes):
    """The index_select of a precomputed row map that computes the same
    dense[:used]; returns a call of it, checked against the kernels."""
    N, OUTCAP = bodies.shape
    _, offs, used, _ = compact.compact_rows(bodies, sizes)
    flat = compact._rows_view(bodies).reshape(-1, compact.ROWW)
    r = torch.arange(int(used), device=bodies.device)
    o64 = offs.to(torch.int64)
    owner = torch.searchsorted(o64, r, right=True) - 1
    row_map = owner * (OUTCAP // 512) + (r - o64[owner])
    kd, _ = compact.compact_rows_kernel(bodies, sizes)
    if not torch.equal(flat.index_select(0, row_map), kd[:len(r)]):
        raise AssertionError("index_select yardstick disagrees")
    return lambda: flat.index_select(0, row_map)


def hbm_bound_ms(n, used_rows):
    """Each input read once, each output written once: the used rows, the
    sizes and the meta."""
    nbytes = 2 * used_rows * 512 + 4 * n + 4 * (2 * n + 1)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def shape_times(compact, label, bodies, sizes):
    """Kernel and index_select times (CUDA-graph replay) at one shape,
    beside its HBM bound."""
    u = int(compact.compact_rows(bodies, sizes)[2])
    k_ms = graph_ms(lambda: compact.compact_rows_kernel(bodies, sizes))
    lib_ms = graph_ms(yardstick(compact, bodies, sizes))
    nbytes, bound = hbm_bound_ms(bodies.shape[0], u)
    print(f"[kernel] compact_rows at {label}, {u} used rows (CUDA-graph "
          f"replay): kernel_ms {k_ms:.4f}, library_ms (index_select) "
          f"{lib_ms:.4f}, bound_ms {bound:.4f} ({nbytes} B at 3.35 TB/s)")


def device_ops(fn, tries: int = 5):
    """Profile one fn() call; returns its device ops, {name: [count,
    device us]}, and the number of windows lost. The profiler now and then
    returns a window that holds no device event at all, though fn ran its
    kernels; such a window says nothing of what fn ran, so fn is profiled
    again, up to `tries` windows. A window with any device event is
    returned as it is."""
    from torch.profiler import ProfilerActivity, profile

    for lost in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = {e.key: [e.count, e.self_device_time_total]
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        if ops:
            return ops, lost
    raise AssertionError(f"the profiler recorded no device op in {tries} "
                         f"windows")


def phase_kernel(out, sizes, slices):
    """compact_rows kernels against their plain version on the card, a
    profiler window over one call on the encode output, and the times of
    the kernels, the plain version, the index_select yardstick, the HBM
    bound and the pinned d2h beside its measured link bound. `slices`
    maps a label to the (bodies, sizes) of another path's call."""
    from aocl_compression_tpu_torch.ops import compact
    dev = out.device
    edge = sizes.clone()
    edge[0], edge[1], edge[2], edge[-1] = 0, B, B + 4096, B
    rng = np.random.default_rng(7)
    nb = torch.from_numpy(rng.integers(0, 256, (16384, 512),
                                       dtype=np.uint8)).to(dev)
    ns = torch.from_numpy(rng.integers(0, 769, 16384).astype(np.int32)
                          ).to(dev)
    u, err = check_compact(compact, "encode sizes", out, sizes)
    for label, (bodies, sz_in) in (
            [("edge sizes", (out, edge)),
             ("random sizes, N=16384 x OUTCAP=512", (nb, ns))]
            + list(slices.items())):
        err = max(err, check_compact(compact, label, bodies, sz_in)[1])

    # the main path's call: only the port's two kernels run on the device
    ops, lost = device_ops(lambda: compact.compact_rows(out, sizes))
    print(f"[kernel] profiler window over one compact_rows ({lost} windows "
          f"with no device event profiled again): device ops (count, device "
          f"us): " + json.dumps(ops))
    ours = ("compact_layout_kernel", "compact_copy_bulk_kernel")
    if (sum(c for c, _ in ops.values()) != 2
            or not all(any(k in name for name in ops) for k in ours)
            or not all(any(k in name for k in ours) for name in ops)):
        raise AssertionError(f"compact_rows ran other device operations than "
                             f"its layout and copy kernels: {ops}")

    library = yardstick(compact, out, sizes)
    times = {}
    for _ in range(2):  # two turns, to see the spread within the run
        times.setdefault("kernel", []).append(graph_ms(
            lambda: compact.compact_rows_kernel(out, sizes)))
        times.setdefault("library", []).append(graph_ms(library))
        times.setdefault("eager", []).append(cuda_ms(
            lambda: compact.compact_rows_kernel(out, sizes), 200))
    plain_ms = graph_ms(lambda: compact.compact_rows_plain(out, sizes), 5, 5)
    kernel_ms, library_ms, eager_ms = (
        min(times[k]) for k in ("kernel", "library", "eager"))
    nbytes, bound_ms = hbm_bound_ms(N, u)
    print(f"[kernel] compact_rows at N={N}, OUTCAP={B} (2 launches, device "
          f"time per call from CUDA-graph replay, min of 2 turns): "
          f"kernel_ms {kernel_ms:.4f}, plain_ms (one turn) {plain_ms:.4f}, "
          f"library_ms (index_select) {library_ms:.4f}, bound_ms "
          f"{bound_ms:.4f} ({nbytes} B at 3.35 TB/s); eager back-to-back "
          f"calls (CUDA events, host launch cost included) {eager_ms:.4f} "
          f"ms per call")
    print(f"[kernel] turns: " + ", ".join(
        f"{k} {' / '.join(f'{t:.4f}' for t in v)}" for k, v in times.items()))

    # the one-block scan at large N (16384 sizes), and the other paths'
    # shapes
    shape_times(compact, "N=16384, OUTCAP=512, random sizes", nb, ns)
    for label, (bodies, sz_in) in slices.items():
        shape_times(compact, label, bodies, sz_in)

    # d2h of dense[:used]: pinned against pageable, and the link's pinned
    # rate on a 256 MB buffer as its bound
    kd, _ = compact.compact_rows_kernel(out, sizes)
    big = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    big_h = torch.empty(big.shape, dtype=torch.uint8, pin_memory=True)
    link_ms = cuda_ms(lambda: big_h.copy_(big, non_blocking=True), 5)
    link_gbs = big.numel() / link_ms / 1e6
    used_d = kd[:u]
    used_h = torch.empty(used_d.shape, dtype=used_d.dtype, pin_memory=True)
    pinned_ms = cuda_ms(lambda: used_h.copy_(used_d, non_blocking=True), 50)
    d2h_bound_ms = u * 512 / link_gbs / 1e6
    # host clock, as the fetch sees it: copy + synchronise
    pinned_wall_ms = wall_ms(lambda: compact._to_pinned(used_d))
    pageable_wall_ms = wall_ms(lambda: used_d.cpu())
    print(f"[kernel] d2h of dense[:used] ({u * 512} B): pinned "
          f"{pinned_ms:.4f} ms (device events), bound {d2h_bound_ms:.4f} ms "
          f"at the pinned link rate {link_gbs:.2f} GB/s (256 MB copy_); "
          f"host clock with the sync, best of 20: pinned "
          f"{pinned_wall_ms:.4f} ms, pageable {pageable_wall_ms:.4f} ms")
    del big, big_h
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, library_ms=library_ms)


# --- the chain-marking kernels (csrc/chain_scan.cu) --------------------------

# kernel name -> the dict of its first check on real inputs (the kernels
# line's times: subchain_reach at the main path's input, chain_marks at
# lz4hc 9's), with the largest error of all its checks
CHAIN = {}


def chain_result(name, res):
    if name in CHAIN:
        CHAIN[name]["max_abs_err"] = max(CHAIN[name]["max_abs_err"],
                                         res["max_abs_err"])
    else:
        CHAIN[name] = res


def reach_steps(reach, subm):
    """subchain_reach's longest lane: the most tiles one sub-chain reaches,
    one step of its walk each."""
    return int(reach.reshape(-1, subm).sum(1).max())


def marks_steps(mark):
    """chain_marks' longest lane, from a row's marks: for each 32,768-
    position window the chain enters, the 128-step sweep, one threading
    step a segment entered and the longest walk from an entry (the most
    marks one segment holds)."""
    segs = mark.reshape(mark.shape[0], -1, 128).sum(2)
    total = torch.zeros(mark.shape[0], dtype=torch.int64, device=mark.device)
    for w in range(0, segs.shape[1], 256):
        ps = segs[:, w:w + 256]
        entered = (ps > 0).sum(1)
        total += torch.where(entered > 0, 128 + entered + ps.max(1).values, 0)
    return int(total.max())


def check_reach(label, nxt, subm):
    """subchain_reach against its plain version on a batch's real input:
    bytes = nxt read once, reach written once."""
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    steps = reach_steps(ld._reach_from_start(nxt, subm), subm)
    res = check_rows("chain kernel", f"subchain_reach ({label})",
                     lambda *a: (ld._reach_from_start(*a),),
                     lambda *a: (ld._reach_from_start_plain(*a),),
                     (nxt, subm), 5 * nxt.numel(), steps)
    chain_result("subchain_reach", res)
    return res


def marks_bytes(nxt, clen):
    """chain_marks' bytes for this input: clen read, nxt read below each
    row's clen (a position at or past it holds no mark, whatever its
    target), mark written whole."""
    C = nxt.shape[1]
    below = int(torch.clamp(clen.to(torch.int64), 0, C).sum())
    return 4 * below + nxt.numel() + 4 * clen.numel()


def check_marks(label, nxt, clen, C):
    """chain_marks against its plain version on a batch's real input:
    bytes as marks_bytes."""
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    steps = marks_steps(ld._chain_marks(nxt, clen, C))
    res = check_rows("chain kernel", f"chain_marks ({label})",
                     lambda *a: (ld._chain_marks(*a),),
                     lambda *a: (ld._chain_marks_plain(*a),),
                     (nxt, clen, C), marks_bytes(nxt, clen), steps)
    chain_result("chain_marks", res)
    return res


def chain_window(label, fn, mem_label, mem_fn, matrices_bytes):
    """A profiler window over one fn() call (none of its device ops a bmm
    or gemm; fn is the caller of a chain kernel with torch ops of its own,
    since a window holding a lone ctypes launch comes back empty more often
    than not), and the peak device memory of one mem_fn() call (the
    kernel's caller) above the memory in use before it, which must stay
    below one fp16 copy of the reachability matrices the plain version
    builds (matrices_bytes)."""
    ops, lost = device_ops(fn)
    mm = [k for k in ops if "gemm" in k.lower() or "bmm" in k.lower()]
    ours = [k for k in ops if "chain_marks_kernel" in k
            or "subchain_reach_kernel" in k]
    extra = peak_above(mem_fn)
    print(f"[chain kernel] profiler window over one {label} call ({lost} "
          f"windows with no device event profiled again): "
          f"{sum(c for c, _ in ops.values())} device launches, "
          f"{sum(us for _, us in ops.values()) / 1e3:.3f} ms device time, "
          f"bmm / gemm ops {mm}, chain kernels in it {ours}; one "
          f"{mem_label} call's peak memory above "
          f"the memory in use before it {extra / 1e6:.2f} MB (one fp16 copy "
          f"of the plain version's matrices: {matrices_bytes / 1e6:.2f} MB)")
    if mm or extra >= matrices_bytes:
        raise AssertionError(f"{label}: the kernel path ran a matrix product "
                             f"or allocated its matrices: {ops}, {extra} B")


def chain_rows_adversarial(C: int, seed: int):
    """Seeded adversarial chains (rows, C) int32 and their clen, as in
    tests/test_torch_chain_scan.py: forward steps (clen C, C - 77, 0, 1), a
    literal run, exits all at C from segment 1 on, exits back to earlier
    segments, exits into the same segment, in-segment self and back edges,
    an in-segment cycle, targets below 0 and past C, random targets."""
    rng = np.random.default_rng(seed)
    idx = np.arange(C)
    S = C // 128
    fwd = lambda hi: np.minimum(idx + rng.integers(1, hi, C), C)  # noqa
    rows, clens = [fwd(9), fwd(9), fwd(9), fwd(9)], [C, C - 77, 0, 1]
    rows.append(np.minimum(idx + 1, C))
    at_c = fwd(40)
    at_c[128:] = C
    rows.append(at_c)
    for k in (3, 12):
        back = fwd(200)
        back[rng.choice(C, k, replace=False)] = rng.integers(0, C, k)
        rows.append(back)
    same = fwd(60)
    p = rng.choice(C, 3 * S, replace=False)
    same[p] = (p // 128) * 128 + rng.integers(0, 128, p.size)
    rows.append(same)
    selfb = fwd(30)
    p = rng.choice(C, 4 * S, replace=False)
    selfb[p[::2]] = p[::2]
    selfb[p[1::2]] = np.maximum(p[1::2] - rng.integers(1, 20, p[1::2].size),
                                (p[1::2] // 128) * 128)
    rows.append(selfb)
    cyc = fwd(7)
    s = rng.integers(0, S)
    seg = np.arange(s * 128, (s + 1) * 128)
    cyc[seg] = s * 128 + (seg - s * 128 + 1) % 128
    rows.append(cyc)
    wild = fwd(50)
    p = rng.choice(C, 2 * S, replace=False)
    wild[p[::2]] = -rng.integers(1, 1000, p[::2].size)
    wild[p[1::2]] = C + rng.integers(1, 1000, p[1::2].size)
    rows.append(wild)
    rows.append(rng.integers(-5, C + 6, C))
    clens += [C] * 5 + [C - 5, C, C, C - 200]
    return (torch.from_numpy(np.array(rows, np.int32)),
            torch.from_numpy(np.array(clens, np.int32)))


def reach_rows_adversarial(M: int, subm: int, seed: int):
    """Seeded adversarial tile chains (rows, M) int32 for subchain_reach:
    forward steps, back and self edges, in-sub-chain cycles, targets below
    0 and past M, a mix."""
    rng = np.random.default_rng(seed)
    idx = np.arange(M)
    base = (idx // subm) * subm
    mixed = idx + rng.integers(1, 9, M)
    p = rng.choice(M, M // 8, replace=False)
    mixed[p] = base[p] + rng.integers(0, subm, p.size)
    rows = [idx + 1, idx + rng.integers(1, 5, M),
            base + rng.integers(0, subm, M), base + (idx - base + 1) % subm,
            rng.integers(-3, M + 4, M), idx.copy(), mixed]
    return torch.from_numpy(np.array(rows, np.int32))


def chain_adversarial(dev):
    """Both chain kernels against their plain versions on seeded
    adversarial rows on the card (chain_marks at C = 4,096 and at 81,920:
    two and a half of the kernel's windows; subchain_reach at SUBM 128, 64
    and 5)."""
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    for C, seed in ((4096, 2), (81920, 5)):
        nxt, clen = (x.to(dev) for x in chain_rows_adversarial(C, seed))
        err = check_equal(f"chain_marks (adversarial, C={C})",
                          [ld._chain_marks(nxt, clen, C)],
                          [ld._chain_marks_plain(nxt, clen, C)])
        chain_result("chain_marks", dict(max_abs_err=err))
        print(f"[chain kernel] chain_marks vs plain on {nxt.shape[0]} seeded "
              f"adversarial rows of C={C}: equal")
    for M, subm in ((1024, 128), (512, 64), (120, 5)):
        nxt = reach_rows_adversarial(M, subm, M + subm).to(dev)
        err = check_equal(f"subchain_reach (adversarial, SUBM {subm})",
                          [ld._reach_from_start(nxt, subm)],
                          [ld._reach_from_start_plain(nxt, subm)])
        chain_result("subchain_reach", dict(max_abs_err=err))
        print(f"[chain kernel] subchain_reach vs plain on {nxt.shape[0]} "
              f"seeded adversarial rows of M={M}, SUBM {subm}: equal")


# kernel name -> its check at the main path's call (the kernels line's
# times), with the largest error of all the match kernels' checks
MATCH = {}

# Every setting an encoder calls _find_matches with, and the options no
# encoder of the API sets (the seeded adversarial rows go through each).
MATCH_SETTINGS = {
    "lz4 main path, snappy G=4": dict(depth=4, nw=8),
    "snappy G=0 (defaults)": dict(),
    "bench config": dict(depth=5, nw=5, ext_passes=5),
    "lz4hc 9": dict(depth=11, nw=32),
    "zlib 1-2": dict(max_off=32768),
    "zstd 1": dict(depth=8),
    "lzma assist": dict(depth=16),
    "nw_deep 2": dict(depth=5, nw=5, nw_deep=2),
    "hash_bits 16": dict(depth=4, nw=16, nw_deep=8, hash_bits=16),
    "max_off 40": dict(max_off=40),
    "offsets 1, 2, 4, 8": dict(depth=3, nw=4, small_offsets=(1, 2, 4, 8),
                               ext_passes=3),
}


def find_matches_call(run):
    """(args, kwargs) of the first lz4_device._find_matches call while
    run() runs, with the defaults filled in."""
    import inspect

    from aocl_compression_tpu_torch.ops import lz4_device as ld
    seen = []
    orig = ld._find_matches

    def wrapped(*args, **kw):
        seen.append((args, kw))
        return orig(*args, **kw)

    ld._find_matches = wrapped
    try:
        run()
    finally:
        ld._find_matches = orig
    bound = inspect.signature(orig).bind(*seen[0][0], **seen[0][1])
    bound.apply_defaults()
    kw = dict(bound.arguments)
    return (kw.pop("data_u8"), kw.pop("n"), kw.pop("B")), kw


def match_bytes(N, Bk):
    """Each input read once, each output written once: data (N, Bk) uint8,
    key / skey / best (N, Bk) int32, n (N,) int32, mlen and moff int32 and
    valid bool; torch.sort writes int64 indices beside the values."""
    nb = N * Bk
    return {"match_keys": 5 * nb, "sort": 16 * nb, "match_candidates": 9 * nb,
            "match_runs": 14 * nb + 4 * N, "_find_matches": 10 * nb + 4 * N}


def check_matches(label, run, main=False):
    """The match kernels against their plain versions on a path's real
    _find_matches call (captured while run() runs): the whole function
    output for output, and each kernel on the kernel path's own inputs
    (match_keys' sorted keys against the plain keys' torch.sort, exactly);
    graph-replay times of each kernel, of torch.sort of the unsorted keys
    (the library call that computes match_keys' function: its library_ms)
    and of the whole kernel path, the plain versions' (device events, one
    call), the HBM bounds and the peak memory of one call of each path.
    main: the kernels line's times."""
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    from aocl_compression_tpu_torch.ops import match_find as mf
    (data, n, Bk), kw = find_matches_call(run)
    data, n = data.contiguous(), n.to(torch.int32).contiguous()
    N = data.shape[0]
    want, plain_ms = device_call_ms(
        lambda: ld._find_matches_plain(data, n, Bk, **kw))
    err = check_equal(f"_find_matches ({label})",
                      list(ld._find_matches(data, n, Bk, **kw)), list(want))
    del want
    hb = kw["hash_bits"]
    cand = (Bk, kw["max_off"], kw["depth"], kw["nw"], kw["nw_deep"])
    runs = (Bk, kw["small_offsets"], kw["nw"], kw["ext_passes"])
    skey = mf.match_keys(data, Bk, hb)
    best = mf.match_candidates(data, skey, *cand)
    stages = {
        "match_keys": (lambda: mf.match_keys(data, Bk, hb),
                       lambda: ld._match_sorted_keys_plain(data, Bk, hb)),
        "match_candidates": (
            lambda: mf.match_candidates(data, skey, *cand),
            lambda: ld._match_candidates_plain(data, skey, *cand)),
        "match_runs": (lambda: mf.match_runs(data, best, n, *runs),
                       lambda: ld._match_runs_plain(data, best, n, *runs))}
    nbytes = match_bytes(N, Bk)
    res = {}
    for name, (kernel, plain) in stages.items():
        want, p_ms = device_call_ms(plain)
        got = kernel()
        e = check_equal(f"{name} ({label})", list(got) if isinstance(
            got, tuple) else [got], list(want) if isinstance(
            want, tuple) else [want])
        del want, got
        res[name] = dict(max_abs_err=e, ms=graph_ms(kernel), plain_ms=p_ms,
                         bound_ms=nbytes[name] / HBM_BYTES_PER_S * 1e3)
    key = ld._match_keys_plain(data, Bk, hb)
    sort_ms = graph_ms(lambda: torch.sort(key, dim=-1))
    res["match_keys"]["library_ms"] = sort_ms
    del key
    whole_ms = graph_ms(lambda: ld._find_matches(data, n, Bk, **kw))
    mem = peak_above(lambda: ld._find_matches(data, n, Bk, **kw))
    mem_plain = peak_above(lambda: ld._find_matches_plain(data, n, Bk, **kw))
    setting = ", ".join(f"{k} {v}" for k, v in kw.items())
    bound = nbytes["_find_matches"] / HBM_BYTES_PER_S * 1e3
    print(f"[match kernel] _find_matches ({label}: N={N}, B={Bk}, {setting}) "
          f"vs plain on the path's real call: equal on mlen, moff, valid; "
          f"kernel path {whole_ms:.4f} ms (CUDA-graph replay: the three "
          f"kernels), plain {plain_ms:.2f} ms (one call, "
          f"device events), bound {bound:.4f} ms "
          f"(data and n read, mlen, moff, valid written once at 3.35 "
          f"TB/s); peak memory of one call above the memory in use before "
          f"it: kernel path {mem / 1e6:.1f} MB, plain {mem_plain / 1e6:.1f} "
          f"MB")
    for name, r in res.items():
        print(f"[match kernel] {name} ({label}) vs its plain version on the "
              f"kernel path's inputs: equal; kernel {r['ms']:.4f} ms (CUDA-"
              f"graph replay), plain {r['plain_ms']:.2f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({nbytes[name]} B at 3.35 TB/s)")
    print(f"[match kernel] torch.sort of the unsorted keys ({label}; the "
          f"library call computing match_keys' function from the keys): "
          f"{sort_ms:.4f} ms (CUDA-graph replay; values and int64 "
          f"indices), bound {nbytes['sort'] / HBM_BYTES_PER_S * 1e3:.4f} "
          f"ms")
    for name, r in res.items():
        prev = MATCH.get(name)
        e = max(r["max_abs_err"], err, prev["max_abs_err"] if prev else 0)
        if main or prev is None:
            MATCH[name] = dict(r)
        MATCH[name]["max_abs_err"] = e


def match_rows_adversarial(Bk: int, seed: int):
    """Seeded adversarial rows (N, Bk) uint8 and their n, as in
    tests/test_torch_match_find.py: text with nonzero bytes past n, an
    all-equal row, two colliding 4-byte words (one 16-bit hash) before a
    common suffix, runs at offsets 4, 2 and 1 across the end-of-block
    clamps (n = Bk - 37, junk after), a far repeat (the ladder), repeats at
    offsets 39, 40 and 41, random bytes."""
    rng = np.random.default_rng(seed)
    words = np.frombuffer(b"the of compression data block match hash ",
                          np.uint8)
    text = lambda k: words[rng.integers(0, words.size, k)]  # noqa: E731
    rows, ns = [], []
    a = rng.integers(1, 256, Bk).astype(np.uint8)
    a[:Bk * 11 // 16] = text(Bk * 11 // 16)
    rows.append(a), ns.append(Bk * 11 // 16)
    rows.append(np.full(Bk, 97, np.uint8)), ns.append(Bk)
    seen = {}
    while True:
        w = int(rng.integers(1, 1 << 32))
        h = ((w * 2654435761) & 0xFFFFFFFF) >> 16
        if h in seen and seen[h] != w:
            pair = [np.frombuffer(np.uint32(x).tobytes(), np.uint8)
                    for x in (seen[h], w)]
            break
        seen[h] = w
    a, suffix = text(Bk), rng.integers(0, 256, 12).astype(np.uint8)
    for i in range(3, Bk - 32, 32):
        a[i:i + 4] = pair[(i // 32) % 2]
        a[i + 4:i + 16] = suffix
    rows.append(a), ns.append(Bk)
    a = rng.integers(1, 256, Bk).astype(np.uint8)
    n = Bk - 37
    a[:n - 120] = text(n - 120)
    a[n - 110:n - 70] = np.tile(np.frombuffer(b"wxyz", np.uint8), 10)
    a[n - 60:n - 2] = np.tile(np.frombuffer(b"ab", np.uint8), 29)
    a[n - 30:n + 10] = 122
    rows.append(a), ns.append(n)
    seg = rng.integers(0, 256, min(400, Bk // 3)).astype(np.uint8)
    rows.append(np.concatenate([seg, text(Bk // 8), seg, seg,
                                text(Bk)])[:Bk]), ns.append(Bk)
    a = rng.integers(0, 256, Bk).astype(np.uint8)
    for p0, dist in ((20, 40), (90, 41), (160, 39)):
        p0 = p0 * Bk // 256
        a[p0 + dist:p0 + dist + 10] = a[p0:p0 + 10]
    rows.append(a), ns.append(Bk)
    rows.append(rng.integers(0, 256, Bk).astype(np.uint8)), ns.append(Bk - 3)
    return (torch.from_numpy(np.stack(rows)),
            torch.from_numpy(np.array(ns, np.int32)))


def match_adversarial(dev):
    """The kernel path against the plain version on seeded adversarial rows
    at every setting of MATCH_SETTINGS, at B = 256 and 4,096."""
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    err = 0
    for Bk, seed in ((256, 31), (4096, 32)):
        data, n = (x.to(dev) for x in match_rows_adversarial(Bk, seed))
        for name, kw in MATCH_SETTINGS.items():
            err = max(err, check_equal(
                f"_find_matches (adversarial, B={Bk}, {name})",
                list(ld._find_matches(data, n, Bk, **kw)),
                list(ld._find_matches_plain(data, n, Bk, **kw))))
        print(f"[match kernel] _find_matches vs plain on {data.shape[0]} "
              f"seeded adversarial rows of B={Bk} at {len(MATCH_SETTINGS)} "
              f"settings: equal")
    for st in MATCH.values():
        st["max_abs_err"] = max(st["max_abs_err"], err)


def ladder_levels(Bk: int, nw: int, ext_passes: int) -> int:
    """P: the ladder's doubling passes, those of ext_passes whose stride
    CAPV * 2^p (CAPV = 4 + 4*nw) stays below Bk."""
    capv, p = 4 + 4 * nw, 0
    while p < ext_passes and capv << p < Bk:
        p += 1
    return p


def runs_rows(N: int, Bk: int, nw: int, ext_passes: int, seed: int):
    """Seeded inputs of match_runs alone whose runs and ladder chains cross
    the slices of a row at every cluster size (K = 2, 4, 8 and 16 CTAs):
    (data (N, Bk) uint8, best (N, Bk) int32 as match_candidates gives it
    (offset << 16 | length, offsets >= 1), n (N,) int32). Row kinds in
    turn: all equal (a run at offset 1 over the row, links everywhere); a
    random segment longer than half the row repeated at its length, its
    candidates saturated (the ladder runs over the rest of the row); chains
    of exactly 2^P - 1 and 2^P links (P = ladder_levels) ending at every
    slice boundary and at Bk - 1, among unsaturated candidates; runs of
    periods 1-8 across every slice boundary, n a little short of Bk."""
    rng = np.random.default_rng(seed)
    capv = 4 + 4 * nw
    chain = 2 ** ladder_levels(Bk, nw, ext_passes)
    tiles = -(-Bk // 32)
    cuts = sorted({-(-tiles // k) * 32 * c for k in (2, 4, 8, 16)
                   for c in range(1, k)} - {0} | {Bk - 1})
    cuts = [c for c in cuts if c < Bk]
    data = rng.integers(0, 256, (N, Bk)).astype(np.uint8)
    off = rng.integers(1, 1 << 16, (N, Bk))
    ln = rng.integers(0, capv, (N, Bk))
    n = np.full(N, Bk, np.int32)
    for r in range(N):
        kind = r % 4
        if kind == 0:
            data[r] = 97
        elif kind == 1:
            seg = min(Bk - 1, Bk // 2 + 37)
            data[r, seg:] = data[r, :Bk - seg]
            off[r, seg:], ln[r, seg:] = seg, capv
        elif kind == 2:    # no two chains overlap: each ends below the last
            free, placed = Bk, 0
            for end in reversed(cuts):
                links = chain - 1 + placed % 2
                start = end - links * capv
                if start < 0 or end >= free:
                    continue
                at = start + capv * np.arange(links + 1)
                off[r, at] = 1 + (placed * 7919) % 65535
                ln[r, at] = capv
                ln[r, end] = capv - 1    # linked into, not saturated
                free, placed = start, placed + 1
        else:
            for end in cuts:
                period = int(rng.integers(1, 9))
                span = int(rng.integers(8, 3 * capv))
                lo, hi = max(0, end - span // 2), min(Bk, end + span // 2)
                data[r, lo:hi] = np.resize(data[r, lo:lo + period], hi - lo)
            n[r] = Bk - int(rng.integers(0, 40))
    best = (off << 16 | ln).astype(np.uint32).view(np.int32)
    return (torch.from_numpy(data), torch.from_numpy(best),
            torch.from_numpy(n))


# match_runs' settings on the seeded rows: every encoder's (offsets 1, 2
# and 4; nw 8, or nw 16 and the other defaults) has no ladder
RUNS_SETTINGS = {
    "lz4 main path (nw 8)": ((1, 2, 4), 8, 0),
    "bench config (nw 5, ext_passes 5)": ((1, 2, 4), 5, 5),
    "offsets 1, 2, 4, 8 (nw 4, ext_passes 3)": ((1, 2, 4, 8), 4, 3),
}


def runs_adversarial(dev):
    """match_runs against its plain version on runs_rows at N = 1, 2, 3, 5
    and 64 rows of 65,536 and at N = 1, 9 and 17 rows of 4,096, at
    RUNS_SETTINGS: the cluster sizes the launcher picks (printed: 16, 8, 4
    and 2 CTAs a row), runs and ladder chains across its slices."""
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    from aocl_compression_tpu_torch.ops import match_find as mf
    err, ctas = 0, []
    for N, Bk in ((1, B), (2, B), (3, B), (5, B), (64, B), (1, 4096),
                  (9, 4096), (17, 4096)):
        for name, (offs, nw, ext) in RUNS_SETTINGS.items():
            data, best, n = (x.to(dev) for x in runs_rows(
                N, Bk, nw, ext, seed=N * Bk + ext))
            got = mf.match_runs(data, best, n, Bk, offs, nw, ext)
            err = max(err, check_equal(
                f"match_runs (seeded rows, N={N}, B={Bk}, {name})",
                list(got), list(ld._match_runs_plain(data, best, n, Bk, offs,
                                                     nw, ext))))
            ctas.append(f"N={N} B={Bk} {name}: K="
                        f"{mf.runs_ctas(N, Bk, offs, nw, ext)}")
    print(f"[match kernel] match_runs vs plain on seeded rows (runs and "
          f"ladder chains across the CTAs' slices): equal; CTAs a row: "
          + "; ".join(ctas))
    MATCH["match_runs"]["max_abs_err"] = max(
        MATCH["match_runs"]["max_abs_err"], err)


# --- the sort-emit serializers (csrc/emit_sorted.cu) -------------------------

# kernel name -> its check at its path's first call (emit_lz4 at phase 4's
# main path, emit_snappy at phase 8's: the kernels line's times), with the
# largest error of all its checks
EMIT = {}
# kernel name -> the largest error of its checks on seeded rows
EMIT_SEEDED_ERR = {}


def emit_fns(fmt):
    """(module, dispatcher name, plain version, kernel wrapper) of the
    serializer of fmt ("lz4" or "snappy")."""
    from aocl_compression_tpu_torch.ops import emit_sorted as es
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    from aocl_compression_tpu_torch.ops import snappy_device as sd
    if fmt == "lz4":
        return ld, "_emit_sorted", ld._emit_sorted_plain, es.emit_lz4
    return (sd, "_emit_snappy_sorted", sd._emit_snappy_sorted_plain,
            es.emit_snappy)


def emit_bytes(N, Bk, G):
    """Each input read once, each output written once: data (N, Bk) uint8,
    n (N,) int32, the tile parse sel (N, M) bool and cpos / cml / coff (N,
    M) int32; out (N, Bk) uint8, body and tail (N,) int32, flag (N,)
    bool."""
    return 2 * N * Bk + 13 * N * (Bk // G) + 13 * N


def _emit_unit(rng, lit):
    """A flagged sequence: lit random bytes whose last 8 hold a word w
    found nowhere else, then w again (a 4-byte match at offset 8, 8-aligned
    when the unit is, so every G <= 8 elects it) and 4 random bytes."""
    a = rng.integers(0, 256, lit + 8).astype(np.uint8)
    a[lit - 8:lit - 4] = a[lit:lit + 4] = rng.integers(0, 256, 4)
    return a


def emit_rows(Bk: int, seed: int):
    """Seeded rows for the emit kernels, (7, Bk) uint8 and their n (int32):
    text with a flagged unit near the front (a literal run of 312 bytes
    closed by a 4-byte match: its headers need more bytes than the match
    has spares), flagged units end to end up to the last match the
    end-of-block rules allow (the lz4 body runs past Bk), random bytes
    (all literal), one repeated byte, text, a padded last block (n = Bk -
    1,093, random bytes past n), random bytes closed by a long match."""
    rng = np.random.default_rng(seed)
    words = np.frombuffer(b"the of compression data block match hash ",
                          np.uint8)
    text = lambda k: words[rng.integers(0, words.size, k)]  # noqa: E731
    out, ns = [], []
    a = text(Bk)
    u = _emit_unit(rng, 320)
    a[64:64 + u.size] = u
    out.append(a), ns.append(Bk)
    k = (Bk - 8) // 280
    lead = (Bk - 8 - 280 * k) // 8 * 8
    a = rng.integers(0, 256, Bk).astype(np.uint8)
    a[lead:lead + 280 * k] = np.concatenate([_emit_unit(rng, 272)
                                             for _ in range(k)])
    out.append(a), ns.append(Bk)
    out.append(rng.integers(0, 256, Bk).astype(np.uint8)), ns.append(Bk)
    out.append(np.full(Bk, 97, np.uint8)), ns.append(Bk)
    out.append(text(Bk)), ns.append(Bk)
    a = text(Bk)
    a[Bk - 1093:] = rng.integers(0, 256, 1093)
    out.append(a), ns.append(Bk - 1093)
    a = rng.integers(0, 256, Bk).astype(np.uint8)
    a[Bk // 2:Bk // 2 + 600] = a[100:700]
    out.append(a), ns.append(Bk)
    return np.stack(out), np.array(ns, np.int32)


def emit_parse(arr, lens, Bk: int, G: int, dev="cpu"):
    """The encoders' tile parse of rows at grid G on dev: the lz4 main
    path's and snappy's matcher settings (depth 4, nw 8), and at G = 8 the
    bench config's (depth 5, nw 5, subm 64, lazy 1, ext_passes 5)."""
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    data = torch.from_numpy(arr).to(dev)
    n = torch.from_numpy(lens).to(dev)
    if G == 8:
        mlen, moff, valid = ld._find_matches(data, n, Bk, depth=5, nw=5,
                                             ext_passes=5)
        valid = ld._lazy_demote(mlen, valid)
        return ld._grid_select(mlen, moff, valid, Bk, G, subm=64,
                               match_cap=ld._match_cap(8, 5, 64, 5))
    mlen, moff, valid = ld._find_matches(data, n, Bk, depth=4, nw=8)
    return ld._grid_select(mlen, moff, valid, Bk, G, match_cap=36)


def emit_irregular(Bk: int, G: int, seed: int, N: int = 4):
    """Seeded tile parses no _grid_select gives, as numpy arrays (rows, n,
    sel, cpos, cml, coff): random selections whose sequences overlap
    (output positions collide, literal runs go negative), lengths from 1,
    offsets up to 70,000, positions anywhere in [0, Bk)."""
    rng = np.random.default_rng(seed)
    M = Bk // G
    sel = rng.random((N, M)) < np.array([0.05, 0.3, 0.6, 0.9])[:N, None]
    t = np.arange(M)[None, :] * G
    cpos = (t + rng.integers(-3 * G, 3 * G, (N, M))).clip(0, Bk - 1)
    cml = rng.integers(1, 90, (N, M))
    coff = rng.integers(1, 70000, (N, M))
    arr = rng.integers(0, 256, (N, Bk)).astype(np.uint8)
    lens = np.array([Bk, Bk - 5, Bk // 2, Bk][:N], np.int32)
    return (arr, lens, sel, cpos.astype(np.int32), cml.astype(np.int32),
            coff.astype(np.int32))


def check_emit(label, fmt, run, main=False):
    """The emit kernel of fmt against its plain version on a path's real
    call (captured while run() runs): all four outputs equal; the kernel's
    graph-replay time, the plain version's (device events, one call), the
    HBM bound, and the peak memory of one dispatcher call (the kernel and
    its outputs) and of one plain call above the memory in use before
    each. main: the kernels line's times."""
    mod, name, plain, kernel = emit_fns(fmt)
    data, n, sel, cpos, cml, coff, Bk, G = capture(mod, name, run)[0]
    args = (data.contiguous(), n.to(torch.int32).contiguous(), sel, cpos,
            cml, coff, Bk, G)
    N = data.shape[0]
    want, plain_ms = device_call_ms(lambda: plain(*args))
    got = kernel(*args)
    err = check_equal(f"emit_{fmt} ({label})", list(got), list(want))
    flagged, past = int(got[3].sum()), int((got[1] > Bk).sum())
    del want, got
    ms = graph_ms(lambda: kernel(*args))
    mem = peak_above(lambda: getattr(mod, name)(*args))
    mem_plain = peak_above(lambda: plain(*args))
    nbytes = emit_bytes(N, Bk, G)
    res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    print(f"[emit kernel] emit_{fmt} ({label}: N={N}, B={Bk}, G={G}; "
          f"{flagged} flagged rows, {past} with body > B) vs its plain "
          f"version on the path's real call: equal on out, body, tail, "
          f"flag; kernel {ms:.4f} ms (CUDA-graph replay), plain "
          f"{plain_ms:.2f} ms (one call, device events), bound "
          f"{res['bound_ms']:.4f} ms ({nbytes} B at 3.35 TB/s); peak "
          f"memory of one call above the memory in use before it: kernel "
          f"{mem / 1e6:.1f} MB, plain {mem_plain / 1e6:.1f} MB")
    key = f"emit_{fmt}"
    prev = EMIT.get(key)
    e = max(err, prev["max_abs_err"] if prev else 0)
    if main or prev is None:
        EMIT[key] = res
    EMIT[key]["max_abs_err"] = e


def emit_adversarial(dev):
    """Both emit kernels against their plain versions (on the card) on
    emit_rows at B = 65,536 and 4,096 through the tile parse at G = 2, 4
    and 8, and on emit_irregular's parses at 1,024 (G = 2, 4, 8)."""
    tot = dict.fromkeys(("rows", "flagged", "past"), 0)
    for fmt in ("lz4", "snappy"):
        _, _, plain, kernel = emit_fns(fmt)
        cases = []
        for Bk, seed in ((65536, 31), (4096, 32)):
            arr, lens = emit_rows(Bk, seed)
            for G in (2, 4, 8):
                cases.append((f"B={Bk}, G={G}", (arr, lens) + tuple(
                    emit_parse(arr, lens, Bk, G, dev)), Bk, G))
        for G in (2, 4, 8):
            cases.append((f"irregular, G={G}",
                          emit_irregular(1024, G, seed=G), 1024, G))
        e = 0
        for label, parts, Bk, G in cases:
            args = tuple(x if torch.is_tensor(x) else
                         torch.from_numpy(x).to(dev) for x in parts)
            want = plain(*args, Bk, G)
            got = kernel(*args, Bk, G)
            e = max(e, check_equal(f"emit_{fmt} ({label})", list(got),
                                   list(want)))
            if not label.startswith("irregular"):
                tot["rows"] += got[0].shape[0]
                tot["flagged"] += int(got[3].sum())
                tot["past"] += int((got[1] > Bk).sum())
        EMIT_SEEDED_ERR[f"emit_{fmt}"] = e
    print(f"[emit kernel] emit_lz4, emit_snappy vs their plain versions on "
          f"seeded rows (emit_rows: {tot['rows']} tile parses at B = 65,536 "
          f"and 4,096, G = 2, 4, 8, {tot['flagged']} of them flagged, "
          f"{tot['past']} with body > B) and on seeded irregular parses "
          f"(colliding output positions, lengths below 4, offsets past 16 "
          f"bits; B = 1,024): equal")


def phase_main(data: bytes, blocks, arr, lens):
    import aocl_compression_tpu_torch as act
    from aocl_compression_tpu_torch.codecs.lz4 import _device_bodies
    from aocl_compression_tpu_torch.parallel import container
    from aocl_compression_tpu_torch.runtime import native

    from aocl_compression_tpu_torch.ops import (chain_scan, emit_sorted,
                                                match_find)
    from aocl_compression_tpu_torch.ops import lz4_device as ld

    dev = arr.device
    mb = len(data) / 1e6
    h = act.setup("lz4", opt_var=2, block_size=B, measure_stats=True)
    c, c_s, n_launch, peak_gb = run_path(
        "main", lambda: act.compress(h, data),
        ("lz4_compress_blocks_multi", "fetch_chunks_kernel"))
    if n_launch != 2 * 3:
        raise AssertionError("compact_rows did not launch its two kernels "
                             "once per compress call")
    if chain_scan.launches["subchain_reach"] != 3:
        raise AssertionError("subchain_reach did not launch once per "
                             "compress call")
    if any(v != 3 for v in match_find.launches.values()):
        raise AssertionError(f"the match kernels did not launch once per "
                             f"compress call: {match_find.launches}")
    if emit_sorted.launches != {"emit_lz4": 3, "emit_snappy": 0}:
        raise AssertionError(f"emit_lz4 did not launch once per compress "
                             f"call: {emit_sorted.launches}")
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

    # per-stage device times of the device tier the API runs (its default
    # config), through the encoder's and the fetch's stage marks
    stage, stream = staged(
        lambda rec: _device_bodies(blocks, 2, dev, mark=rec),
        ("start", "h2d", "find_matches", "lazy", "grid_select",
         "emit_sorted", "compaction", "meta_d2h"),
        lambda r: stitch_rap(*r, blocks), "host_stitch_rap")
    if stream != c:
        raise AssertionError("staged device tier stream differs from the "
                             "API's")
    print("[main] stage times, ms (min of 3; device events, host clock for "
          "the stitch and RAP after the fetch; the d2h copies are pinned): "
          + fmt_stages(stage))
    STREAMS["lz4"] = c
    check_matches("lz4 main path", lambda: act.compress(h, data), main=True)
    match_adversarial(dev)
    runs_adversarial(dev)
    check_emit("lz4 main path", "lz4", lambda: act.compress(h, data),
               main=True)
    emit_adversarial(dev)

    # the chain marking of the main path's encode: subchain_reach on its
    # real input, and one _grid_select call (device ops, memory)
    nxt, subm = capture(ld, "_reach_from_start",
                        lambda: ld.make_encoder(B, 4)(arr, lens))[0]
    check_reach("main path", nxt, subm)
    mlen, moff, valid = ld._find_matches(arr, lens, B, depth=4, nw=8)
    chain_window("_grid_select (main path)", lambda: ld._grid_select(
        mlen, moff, valid, B, 4, match_cap=ld._match_cap(4, 8, 128, 0)),
        "_reach_from_start", lambda: ld._reach_from_start(nxt, subm),
        2 * nxt.numel() * subm)
    return n_launch, c


def phase_bench(data: bytes, blocks, arr, lens):
    from aocl_compression_tpu_torch.codecs import lz4_stitch
    from aocl_compression_tpu_torch.ops import compact, lz4_device
    from aocl_compression_tpu_torch.runtime import native

    enc = lz4_device.make_encoder(B, 8, 5, 5, subm=64, lazy=1, ext_passes=5)

    def run():
        out, sizes, tails, flags = enc(arr, lens)
        return compact.fetch_chunks(out, sizes), tails, flags

    run()
    torch.cuda.synchronize()
    reset_counts()
    (bodies, tails, flags), t = best_s(run)
    counts = tally_paths()
    if counts["emit_lz4"] != 3:
        raise AssertionError(f"bench: emit_lz4 did not launch once per "
                             f"call: {counts}")
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
          f"stitched stream decodes exactly; {int(flags.sum())} flagged "
          f"blocks; chain, match and emit kernels' launches in 3 calls: "
          f"{json.dumps(counts)}")
    nxt, subm = capture(lz4_device, "_reach_from_start",
                        lambda: enc(arr, lens))[0]
    check_reach(f"bench config, SUBM {subm}", nxt, subm)
    check_matches("bench config", lambda: enc(arr, lens))
    check_emit("bench config", "lz4", lambda: enc(arr, lens))


def rap_stream(chunks, dlens, pre=b""):
    """The RAP stream the container writes around `chunks` (the codec's
    preamble `pre` after the frame)."""
    from aocl_compression_tpu_torch.runtime import native
    offsets = np.cumsum([0] + [len(x) for x in chunks[:-1]])
    frame = native.rap_write(len(chunks), offsets + native.rap_frame_len(
        len(chunks)) + len(pre), [len(x) for x in chunks], dlens)
    return frame + pre + b"".join(chunks)


def stitch_rap(bodies, tails, blocks):
    """The RAP stream the API writes from the lz4 encoder's bodies and
    tails."""
    from aocl_compression_tpu_torch.codecs import lz4_stitch
    return rap_stream(*lz4_stitch.stitch_bodies(bodies, tails, blocks))


def staged(run, names, finish, host_stage, calls=3, after=()):
    """run(rec) `calls` times, rec(stage) recording a CUDA event at each
    stage mark of the code it drives: ({stage: [ms, ...]}, the RAP stream
    finish() makes of the last call's result). Each stage is timed from
    the mark before it; d2h from d2h_start; the marks in `after` (host
    work after the fetch) from d2h on; host_stage (finish) on the host
    clock."""
    stage = {k: [] for k in names[1:] + ("d2h",) + after + (host_stage,)}
    for _ in range(calls):
        ev = {k: torch.cuda.Event(enable_timing=True)
              for k in names + ("d2h_start", "d2h") + after}
        res = run(lambda k: ev[k].record())
        t1 = time.perf_counter()
        stream = finish(res)
        stage[host_stage].append((time.perf_counter() - t1) * 1e3)
        for a, b in zip(names, names[1:]):
            stage[b].append(ev[a].elapsed_time(ev[b]))
        stage["d2h"].append(ev["d2h_start"].elapsed_time(ev["d2h"]))
        for a, b in zip(("d2h",) + after, after):
            stage[b].append(ev[a].elapsed_time(ev[b]))
    return stage, stream


def fmt_stages(stage):
    return ", ".join(f"{k} {min(v):.3f}" for k, v in stage.items())


def reset_counts():
    """Every kernel launch count (compact.launches, zstd_scan.launches,
    inflate_scan.launches, entropy_scan.launches, chain_scan.launches,
    match_find.launches, emit_sorted.launches) to 0."""
    from aocl_compression_tpu_torch.ops import (chain_scan, compact,
                                                emit_sorted, entropy_scan,
                                                inflate_scan, match_find,
                                                zstd_scan)
    compact.launches = 0
    for counts in (zstd_scan.launches, inflate_scan.launches,
                   entropy_scan.launches, chain_scan.launches,
                   match_find.launches, emit_sorted.launches):
        for k in counts:
            counts[k] = 0


# The chain, match and emit kernels' launches summed over every path run
# with the counts set to 0 just before (run_path, counted, in_turns, phase
# 5): the kernels line's counts.
PATH_LAUNCHES = {"subchain_reach": 0, "chain_marks": 0, "match_keys": 0,
                 "match_candidates": 0, "match_runs": 0, "emit_lz4": 0,
                 "emit_snappy": 0}


def tally_paths():
    """chain_scan.launches, match_find.launches and emit_sorted.launches
    since the last reset_counts(), added to PATH_LAUNCHES; returns them."""
    from aocl_compression_tpu_torch.ops import (chain_scan, emit_sorted,
                                                match_find)
    got = dict(chain_scan.launches, **match_find.launches,
               **emit_sorted.launches)
    for k, v in got.items():
        PATH_LAUNCHES[k] += v
    return got


def run_path(label, fn, hits_want, calls=3, per_call=None):
    """fn() `calls` times with the audit on and every kernel count
    (compact.launches, zstd_scan.launches, inflate_scan.launches,
    entropy_scan.launches) set to 0 just before: (last result, best s,
    compact_rows launches, peak device GB); the scan kernels' counts stay in
    zstd_scan.launches, inflate_scan.launches and entropy_scan.launches
    for the caller to read (the chain kernels' are also added to
    PATH_LAUNCHES). Fails unless every audit
    name in hits_want was hit `calls` times (times per_call[name] where
    given)."""
    from aocl_compression_tpu_torch.ops import compact
    from aocl_compression_tpu_torch.utils import dispatch
    fn()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.enable_audit(True)
    reset_counts()
    try:
        res, t = best_s(fn, calls)
        launches = compact.launches
        hits = dispatch.audit_hits()
    finally:
        dispatch.enable_audit(False)
    chain = tally_paths()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{label}] dispatch audit: {json.dumps(hits, sort_keys=True)}; "
          f"compact_rows launches in {calls} calls: {launches}; chain, "
          f"match and emit kernels' launches: {json.dumps(chain)}")
    for name in hits_want:
        if hits.get(name) != calls * (per_call or {}).get(name, 1):
            raise AssertionError(f"{label}: {name} was not hit as often as "
                                 f"the calls want")
    return res, t, launches, peak_gb


def phase_lz4hc(data: bytes, blocks, arr, lens):
    """setup("lz4hc", opt_var=2) at the default level 9: the exact-parse
    device encoder (G=0, depth 11, nw 32, lazy 1)."""
    import aocl_compression_tpu_torch as act
    from aocl_compression_tpu_torch.codecs.lz4 import _device_bodies
    from aocl_compression_tpu_torch.codecs.lz4hc import device_params
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    from aocl_compression_tpu_torch.ops import match_find
    from aocl_compression_tpu_torch.parallel import container
    from aocl_compression_tpu_torch.runtime import native

    mb = len(data) / 1e6
    h = act.setup("lz4hc", opt_var=2, block_size=B)
    c, c_s, launches, peak_gb = run_path(
        "lz4hc", lambda: act.compress(h, data),
        ("lz4hc_compress_blocks_torch", "fetch_chunks_kernel"))
    if launches != 2 * 3:
        raise AssertionError("lz4hc: compact_rows did not launch its two "
                             "kernels once per compress call")
    if any(v != 3 for v in match_find.launches.values()):
        raise AssertionError(f"lz4hc: the match kernels did not launch once "
                             f"per compress call: {match_find.launches}")
    if act.decompress(h, c) != data:
        raise AssertionError("lz4hc: decompress did not return the input")
    if native.lz4_decompress(container.skip_rap_frame(c), len(data)) != data:
        raise AssertionError("lz4hc: serial decode after skip_rap_frame "
                             "failed")
    hh = act.setup("lz4hc", level=9, block_size=B)
    ch, ch_s = best_s(lambda: act.compress(hh, data), 1)
    print(f"[lz4hc] setup('lz4hc', opt_var=2, block_size={B}) level "
          f"{h.level} on {h.device}: {len(data)} B -> {len(c)} B, ratio "
          f"{len(data) / len(c):.4f} (host tier at level 9: {len(ch)} B, "
          f"ratio {len(data) / len(ch):.4f}, {mb / ch_s:.2f} MB/s, one "
          f"call); compress {mb / c_s:.2f} MB/s (best of 3, "
          f"{c_s * 1e3:.2f} ms); round trip exact, serial decode exact; "
          f"peak device memory {peak_gb:.2f} GB")

    depth, nw, lazy = device_params(9)
    stage, stream = staged(
        lambda rec: _device_bodies(blocks, 1, arr.device, depth=depth, nw=nw,
                                   lazy=lazy, mark=rec),
        ("start", "h2d", "find_matches", "lazy", "greedy_parse",
         "select_sequences", "emit", "compaction", "meta_d2h"),
        lambda r: stitch_rap(*r, blocks), "host_stitch_rap")
    if stream != c:
        raise AssertionError("lz4hc: staged device tier stream differs from "
                             "the API's")
    print("[lz4hc] stage times, ms (min of 3; device events, host clock for "
          "the stitch and RAP after the fetch): " + fmt_stages(stage))
    check_matches("lz4hc 9", lambda: act.compress(h, data))

    # mem_limit bounds the device batches (here two halves of the corpus)
    # and leaves the stream as it is
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hm = act.setup("lz4hc", opt_var=2, block_size=B, mem_limit=len(data) // 2)
    if act.compress(hm, data) != c:
        raise AssertionError("lz4hc: mem_limit changed the stream")
    print(f"[lz4hc] mem_limit={len(data) // 2} (two device batches): same "
          f"stream; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # the launches of one _greedy_parse call (the exact parse's marking:
    # its chain step and _chain_marks) on the level-9 candidates
    mlen, _, valid = ld._find_matches(arr, lens, B, depth=depth, nw=nw)
    for _ in range(lazy):
        valid = ld._lazy_demote(mlen, valid)
    ops = device_ops(lambda: ld._greedy_parse(mlen, valid, B))[0].values()
    nxt, clen, C = capture(ld, "_chain_marks",
                           lambda: ld._greedy_parse(mlen, valid, B))[0]
    pops = device_ops(lambda: ld._chain_marks_plain(nxt, clen, C))[0].values()
    print(f"[lz4hc] one _greedy_parse call (N={N}, C={B}), the kernel path: "
          f"{sum(c for c, _ in ops)} device launches, "
          f"{sum(us for _, us in ops) / 1e3:.3f} ms device time (profiler); "
          f"one call of the plain _chain_marks_plain on its input (the "
          f"parent's path): {sum(c for c, _ in pops)} device launches, "
          f"{sum(us for _, us in pops) / 1e3:.3f} ms device time")
    check_marks("lz4hc 9 greedy parse", nxt, clen, C)
    chain_window("_greedy_parse (lz4hc 9)",
                 lambda: ld._greedy_parse(mlen, valid, B), "_chain_marks",
                 lambda: ld._chain_marks(nxt, clen, C), 2 * nxt.numel() * 128)
    chain_adversarial(arr.device)
    return launches, c, peak_gb


def phase_decode(data: bytes, streams, dev):
    """Device decode (set_config(device_decode=True)) of the lz4 and lz4hc
    streams through the API, beside the host decoder; then the stages of
    one device batch of the lz4hc stream."""
    import aocl_compression_tpu_torch as act
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    from aocl_compression_tpu_torch.runtime import native

    mb = len(data) / 1e6
    total = 0
    for method, c in streams.items():
        h = act.setup(method, opt_var=2, block_size=B)
        act.set_config(device_decode=True)
        try:
            d, d_s, launches, peak_gb = run_path(
                f"decode {method}", lambda: act.decompress(h, c),
                ("lz4_decompress_blocks_multi", "fetch_chunks_kernel"))
        finally:
            act.set_config(device_decode=False)
        if d != data:
            raise AssertionError(f"device decode of the {method} stream did "
                                 f"not return the input")
        if launches != 2 * 3:
            raise AssertionError(f"decode {method}: compact_rows did not "
                                 f"launch its two kernels once per call")
        total += launches
        _, h_s = best_s(lambda: act.decompress(h, c))
        dlens = native.rap_parse(c)[2]
        on_dev = dlens <= ld.MAX_DEVICE_BLOCK
        print(f"[decode] {method} stream ({len(c)} B): device decode "
              f"{mb / d_s:.2f} MB/s (best of 3, {d_s * 1e3:.2f} ms), host "
              f"decoder {mb / h_s:.2f} MB/s (best of 3); exact; chunks on "
              f"the device {int(on_dev.sum())} of {len(dlens)} "
              f"({int(dlens[on_dev].sum())} of {int(dlens.sum())} B), the "
              f"rest (> 64 KiB) on the host tier; peak device memory "
              f"{peak_gb:.2f} GB")

    # stages of the device batch of the lz4hc stream, through
    # decode_blocks's stage marks; checked against the host decoder
    c = streams["lz4hc"]
    offs, lens_, dlens = native.rap_parse(c)
    sel = [i for i, d in enumerate(dlens) if d <= ld.MAX_DEVICE_BLOCK]
    chunks = [c[int(offs[i]):int(offs[i]) + int(lens_[i])] for i in sel]
    dl = [int(dlens[i]) for i in sel]
    stage, passes, got = decode_stages(ld.decode_blocks, chunks, dl, dev,
                                       "token_scan")
    if got != [native.lz4_decompress(x, d) for x, d in zip(chunks, dl)]:
        raise AssertionError("decode: device batch differs from the host "
                             "decoder")
    nxt, clen, C = capture(ld, "_chain_marks", lambda: ld.decode_blocks(
        chunks, dl, B, device=dev))[0]
    check_marks("lz4hc stream's device decode batch", nxt, clen, C)
    print(f"[decode] lz4hc device batch: N={len(chunks)}, C="
          f"{ld._bucket(max(len(x) for x in chunks))}, B="
          f"{ld._bucket(max(max(dl), B))}, resolve passes {passes}; "
          f"stage times, ms (min of 3; device events; h2d_batch spans the "
          f"host's batch build and the upload): " + fmt_stages(stage))
    return total


def decode_stages(decode_blocks, chunks, dl, dev, scan_name):
    """Stage times of one device batch through a decoder's stage marks:
    ({stage: [ms, ...]}, resolve passes, the decoded chunks)."""
    names = ("start", "h2d_batch", scan_name, "chain_marks", "output_map",
             "resolve", "gather_output", "compaction", "meta_d2h")
    stage = {k: [] for k in names[1:] + ("d2h",)}
    for _ in range(3):
        ev = {k: torch.cuda.Event(enable_timing=True)
              for k in names + ("d2h_start", "d2h")}
        passes = []

        def rec(k):
            if k == "resolve_pass":
                passes.append(k)
            else:
                ev[k].record()

        got = decode_blocks(chunks, dl, B, device=dev, mark=rec)
        for a_, b_ in zip(names, names[1:]):
            stage[b_].append(ev[a_].elapsed_time(ev[b_]))
        stage["d2h"].append(ev["d2h_start"].elapsed_time(ev["d2h"]))
    return stage, len(passes), got


def check_pinned(label, stream):
    """The port's stream of the corpus's first PINNED_BLOCKS blocks against
    the JAX package's sha256 (tests/test_torch_pinned.py)."""
    digest = hashlib.sha256(stream).hexdigest()
    if digest != PINNED_SHA256[label]:
        raise AssertionError(f"{label}: the {PINNED_BLOCKS}-block stream's "
                             f"sha256 {digest} is not the JAX package's "
                             f"{PINNED_SHA256[label]}")
    print(f"[{label}] first {PINNED_BLOCKS} blocks: {len(stream)} B, sha256 "
          f"{digest} = the JAX package's")


def phase_snappy(data: bytes, blocks, dev):
    """setup("snappy", opt_var=2): the sort-emit snappy encoder (G=4,
    depth 4, nw 8) and, with device decode on, the snappy decoder."""
    import aocl_compression_tpu_torch as act
    from aocl_compression_tpu_torch.codecs.snappy import (_device_frags,
                                                          _varint)
    from aocl_compression_tpu_torch.ops import emit_sorted
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    from aocl_compression_tpu_torch.ops import snappy_device as sd
    from aocl_compression_tpu_torch.parallel import container
    from aocl_compression_tpu_torch.runtime import native

    mb = len(data) / 1e6
    method, kw = PINNED_CALLS["snappy"]
    h = act.setup(method, **kw)
    c, c_s, launches, peak_gb = run_path(
        "snappy", lambda: act.compress(h, data),
        ("snappy_compress_blocks_multi", "fetch_chunks_kernel"))
    if launches != 2 * 3:
        raise AssertionError("snappy: compact_rows did not launch its two "
                             "kernels once per compress call")
    if emit_sorted.launches != {"emit_lz4": 0, "emit_snappy": 3}:
        raise AssertionError(f"snappy: emit_snappy did not launch once per "
                             f"compress call: {emit_sorted.launches}")
    d, d_s = best_s(lambda: act.decompress(h, c))
    if d != data:
        raise AssertionError("snappy: decompress did not return the input")
    if native.snappy_uncompress(container.skip_rap_frame(c)) != data:
        raise AssertionError("snappy: serial decode after skip_rap_frame "
                             "failed")
    hh = act.setup("snappy", block_size=B)
    ch, ch_s = best_s(lambda: act.compress(hh, data))
    print(f"[snappy] setup('snappy', opt_var=2) on {h.device}: {len(data)} "
          f"B -> {len(c)} B, ratio {len(data) / len(c):.4f} (host tier: "
          f"{len(ch)} B, ratio {len(data) / len(ch):.4f}, {mb / ch_s:.2f} "
          f"MB/s, best of 3); compress {mb / c_s:.2f} MB/s (best of 3, "
          f"{c_s * 1e3:.2f} ms); host decode {mb / d_s:.2f} MB/s; round trip "
          f"exact, serial decode exact; peak device memory {peak_gb:.2f} GB")
    check_pinned("snappy", act.compress(h, data[:PINNED_BLOCKS * B]))
    STREAMS["snappy"] = c
    check_matches("snappy", lambda: act.compress(h, data))
    check_emit("snappy", "snappy", lambda: act.compress(h, data), main=True)

    stage, stream = staged(
        lambda rec: _device_frags(blocks, 2, dev, mark=rec),
        ("start", "h2d", "find_matches", "grid_select", "emit_sorted",
         "compaction", "meta_d2h"),
        lambda frags: rap_stream(frags, [len(b) for b in blocks],
                                 _varint(len(data))),
        "host_rap", after=("tails",))
    if stream != c:
        raise AssertionError("snappy: staged device tier stream differs "
                             "from the API's")
    print("[snappy] stage times, ms (min of 3; device events; tails = the "
          "host's trailing literal elements after the fetch; host_rap on "
          "the host clock): " + fmt_stages(stage))

    # device decode through the API, beside the host decoder
    act.set_config(device_decode=True)
    try:
        dd, dd_s, dlaunches, dpeak_gb = run_path(
            "decode snappy", lambda: act.decompress(h, c),
            ("snappy_decompress_blocks_torch", "fetch_chunks_kernel"))
    finally:
        act.set_config(device_decode=False)
    if dd != data:
        raise AssertionError("snappy: device decode did not return the "
                             "input")
    offs, lens_, dlens = native.rap_parse(c)
    chunks = [c[int(o):int(o) + int(n)] for o, n in zip(offs, lens_)]
    C = ld._bucket(max(len(x) for x in chunks))
    batches = -(-len(chunks) // max(1, (32 << 20) // C))
    if dlaunches != 2 * 3 * batches:
        raise AssertionError("decode snappy: compact_rows did not launch its "
                             "two kernels once per device batch")
    print(f"[decode snappy] {len(c)} B stream: device decode "
          f"{mb / dd_s:.2f} MB/s (best of 3, {dd_s * 1e3:.2f} ms), host "
          f"decoder {mb / d_s:.2f} MB/s (best of 3); exact; all "
          f"{len(chunks)} chunks on the device in {batches} batch(es) of "
          f"C={C}; peak device memory {dpeak_gb:.2f} GB")
    dl = [int(x) for x in dlens]
    stage, passes, got = decode_stages(sd.decode_blocks, chunks, dl, dev,
                                       "tag_scan")
    if b"".join(got) != data:
        raise AssertionError("decode snappy: staged batch differs")
    nxt, clen, C = capture(ld, "_chain_marks", lambda: sd.decode_blocks(
        chunks, dl, B, device=dev))[0]
    check_marks("snappy device decode batch", nxt, clen, C)
    print(f"[decode snappy] device batch: N={len(chunks)}, C={C}, resolve "
          f"passes {passes}; stage times, ms (min of 3; device events): "
          + fmt_stages(stage))
    return launches + dlaunches


# --- the entropy-table kernels (csrc/entropy_scan.cu) ----------------------

def check_rows(tag, label, kernel, plain, args, nbytes, steps):
    """A kernel (an entropy-table or chain-marking one) against its plain
    version on the whole batch's real inputs on the card (every output
    equal; both return tuples), the kernel's graph-replay time, the plain
    version's (device events, one call), the HBM bound and the serial
    floor: dict(max_abs_err, ms, plain_ms, bound_ms, steps, ...)."""
    want, plain_ms = device_call_ms(lambda: plain(*args))
    got = kernel(*args)
    torch.cuda.synchronize()
    err = check_equal(label, list(got), list(want))
    ms = graph_ms(lambda: kernel(*args))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[{tag}] {label} vs plain on the whole batch's real inputs "
          f"(N={args[0].shape[0]}): equal on every output; kernel {ms:.4f} "
          f"ms (CUDA-graph replay), plain version {plain_ms:.2f} ms (one call, "
          f"device events), bound {bound:.4f} ms ({nbytes} B at 3.35 TB/s), "
          f"longest row {steps} serial steps")
    st = per_step(tag, label, lambda: kernel(*args), ms, steps)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                steps=steps, **st)


def kraft_bytes(nbs):
    """kraft_absorb's bytes: nbs and d0 read, nbs2 and D written."""
    return 2 * 4 * (nbs.numel() + nbs.shape[0])


def kraft_steps(nbs, nbs2) -> int:
    """kraft_absorb's serial steps on the longest row of the run walk:
    the row's runs of equal lengths plus its steps with k = nbs - nbs2 >
    0 (the steps that change a length)."""
    nbs, nbs2 = nbs.cpu(), nbs2.cpu()
    runs = 1 + (nbs[:, 1:] != nbs[:, :-1]).sum(dim=1)
    return int((runs + (nbs2 != nbs).sum(dim=1)).max())


def entropy_phases(label, name, args, ms):
    """Print the SM cycles a warp of each phase of an entropy-table kernel
    on args, as its C entry point takes them, from the build with phase
    stamps (scripts/entropy_phases.py), with the span of its warps and the
    launch and drain (ms, the kernel's graph-replay time, less the span)."""
    import entropy_phases as ep
    lib, names = ENTROPY_PHASES["lib"]
    print(ep.line("entropy kernel phases", label,
                  ep.phases(lib, names, name, args, ms)))


def kraft_direct(dev, seed: int = 21, n: int = 257, nsym: int = 288,
                 maxlen: int = 15):
    """kraft_absorb called directly on a seeded batch of unsorted lengths
    in [0, maxlen] and arbitrary int32 deficits (every 16th row one run,
    every 16th all zero), held to its plain loop; returns the max abs
    error (0)."""
    from aocl_compression_tpu_torch.ops import deflate_device as dd
    from aocl_compression_tpu_torch.ops import entropy_scan
    rng = np.random.default_rng(seed)
    nbs = rng.integers(0, maxlen + 1, (n, nsym))
    nbs[::16] = rng.integers(1, maxlen + 1, (len(nbs[::16]), 1))
    nbs[5::16] = 0
    d = rng.integers(-(1 << 31), 1 << 31, n)
    d[::7] = rng.integers(-(1 << maxlen), (1 << maxlen) + 1, len(d[::7]))
    nbs = torch.from_numpy(nbs.astype(np.int32))
    d = torch.from_numpy(d.astype(np.int32))
    got = entropy_scan.kraft_absorb(nbs.to(dev), d.to(dev), maxlen)
    err = check_equal("kraft_absorb (direct batch)", [g.cpu() for g in got],
                      dd._kraft_absorb_plain(nbs, d, maxlen))
    print(f"[entropy kernel] kraft_absorb called directly vs plain on a "
          f"seeded batch of {n} x {nsym} unsorted lengths in [0, {maxlen}] "
          f"(one-run and all-zero rows among them) with arbitrary int32 "
          f"deficits: equal on every output")
    return err


def kraft_hists(nsym: int, seed: int):
    """Seeded adversarial (rows, nsym) int32 histograms, as in
    tests/test_torch_entropy_scan.py: no symbol, one present symbol, two,
    all present, all-equal counts, a 65,536-count symbol whose share wraps
    negative in int32, two 70,000-count symbols, (nsym >= 74) counts 2^15
    .. 2^6 and 64 ones whose Kraft sum passes 1, and random rows."""
    rng = np.random.default_rng(seed)
    rows = [np.zeros(nsym), np.eye(nsym)[3] * 5,
            np.eye(nsym)[0] + np.eye(nsym)[nsym - 1] * 9,
            rng.integers(1, 3000, nsym), np.full(nsym, 250)]
    for idx, counts in (([1, 7, nsym - 2], [65536, 3, 1]),
                        ([0, 5], [70000, 70000])):
        h = np.zeros(nsym)
        h[idx] = counts
        rows.append(h)
    if nsym >= 74:
        h = np.zeros(nsym)
        h[rng.choice(nsym, 74, replace=False)] = (
            [1 << e for e in range(15, 5, -1)] + [1] * 64)
        rows.append(h)
    for _ in range(8):
        k = rng.integers(2, nsym + 1)
        h = np.zeros(nsym)
        h[rng.choice(nsym, k, replace=False)] = rng.integers(
            1, 4000, k) ** rng.integers(1, 3)
        rows.append(h)
    return torch.from_numpy(np.array(rows, np.int32))


def lit_rows_adversarial(seed: int = 7, width: int = 4096):
    """Seeded adversarial literal rows (rows, width) int32 and their counts
    for _block_huffman, as in tests/test_torch_entropy_scan.py: no literal,
    one, one symbol repeated, all 256 symbols, 64 equal counts, counts
    2^11 .. 2^1 and two ones (symbol 255 among them; a Kraft sum past 1),
    random and skewed rows."""
    rng = np.random.default_rng(seed)
    fail = np.concatenate([np.full(1 << e, e) for e in range(11, 0, -1)]
                          + [[100, 255]])
    vals = [[], [9], np.full(width, 7),
            rng.permutation(np.arange(width) % 256), np.arange(width) % 64,
            rng.permutation(fail), rng.integers(0, 256, width),
            np.minimum(rng.geometric(0.05, width), 255)]
    rows = np.zeros((len(vals), width), np.int32)
    for i, v in enumerate(vals):
        rows[i, :len(v)] = v
    n = np.array([len(v) for v in vals], np.int32)
    return torch.from_numpy(rows), torch.from_numpy(n)


def weight_rows_adversarial(real, seed: int = 9):
    """Seeded adversarial weight rows (rows, 255) int32: the real weights
    of lit_rows_adversarial's Kraft-exact rows (`real`), all 0, all 11,
    alternating 0 / 11, a ramp over the 12 symbols, and random rows."""
    rng = np.random.default_rng(seed)
    edge = np.array([np.zeros(255), np.full(255, 11),
                     np.arange(255) % 2 * 11, np.arange(255) % 12])
    return torch.cat([real, torch.from_numpy(np.concatenate(
        [edge, rng.integers(0, 12, (8, 255))]).astype(np.int32))])


def kraft_adversarial(label, module, run, dev):
    """kraft_absorb on the card against its plain loop on the CPU, on the
    (nbs, D) that run() (a CPU call of module's _kraft_lengths or
    _block_huffman on adversarial rows) gives the absorb; every output
    equal. Returns the max abs error (0)."""
    from aocl_compression_tpu_torch.ops import deflate_device as dd
    (nbs, D, m), = capture(module, "_kraft_absorb", run)
    got = dd._kraft_absorb(nbs.to(dev), D.to(dev), m)
    err = check_equal(label, [g.cpu() for g in got],
                      dd._kraft_absorb_plain(nbs, D, m))
    nfail = int((~run()[-1]).sum())
    print(f"[entropy kernel] {label} vs plain on {nbs.shape[0]} seeded "
          f"adversarial rows ({nfail} with ok False): equal on every output")
    return err


def phase_zlib(data: bytes, blocks, dev):
    """setup("zlib", level=1|2, opt_var=2): the static and the dynamic
    device deflate encoders (G=4, 32 KiB window); decode on the host."""
    import zlib

    import aocl_compression_tpu_torch as act
    from aocl_compression_tpu_torch.codecs.zlib_bzip2_lzma import (
        _device_chunks, _trailer)
    from aocl_compression_tpu_torch.ops import deflate_device as dd
    from aocl_compression_tpu_torch.ops import entropy_scan
    from aocl_compression_tpu_torch.parallel import container

    mb = len(data) / 1e6
    total = 0
    streams = {}
    kraft_launches = 0
    stages = {1: ("start", "h2d", "find_matches", "grid_parse", "emit",
                  "compaction", "meta_d2h"),
              2: ("start", "h2d", "find_matches", "grid_parse", "histograms",
                  "kraft_lengths", "canonical_codes", "emit", "compaction",
                  "meta_d2h")}
    for level in (1, 2):
        label = f"zlib level {level}"
        method, kw = PINNED_CALLS[label]
        h = act.setup(method, **kw)
        c, c_s, launches, peak_gb = run_path(
            f"zlib{level}", lambda: act.compress(h, data),
            ("zlib_compress_blocks_multi", "fetch_chunks_kernel"))
        if launches != 2 * 3:
            raise AssertionError(f"{label}: compact_rows did not launch its "
                                 f"two kernels once per compress call")
        kraft = entropy_scan.launches["kraft_absorb"]
        if kraft != (2 * 3 if level == 2 else 0):
            raise AssertionError(f"{label}: kraft_absorb launched {kraft} "
                                 f"times in 3 calls")
        kraft_launches += kraft
        total += launches
        d, d_s = best_s(lambda: act.decompress(h, c))
        if d != data:
            raise AssertionError(f"{label}: decompress did not return the "
                                 f"input")
        if zlib.decompress(container.skip_rap_frame(c)) != data:
            raise AssertionError(f"{label}: stdlib zlib does not read the "
                                 f"stream after skip_rap_frame")
        print(f"[zlib{level}] setup('zlib', level={level}, opt_var=2) on "
              f"{h.device}: {len(data)} B -> {len(c)} B, ratio "
              f"{len(data) / len(c):.4f}; compress {mb / c_s:.2f} MB/s (best "
              f"of 3, {c_s * 1e3:.2f} ms); host decode {mb / d_s:.2f} MB/s; "
              f"round trip exact, stdlib zlib reads it after skip_rap_frame; "
              f"peak device memory {peak_gb:.2f} GB; kraft_absorb launches "
              f"in 3 calls: {kraft}")
        check_pinned(label, act.compress(h, data[:PINNED_BLOCKS * B]))
        streams[level] = STREAMS[label] = c
        if level == 1:   # level 2 calls the match finder as level 1 does
            check_matches("zlib 1", lambda: act.compress(h, data))
        stage, stream = staged(
            lambda rec: _device_chunks(blocks, level, dev, mark=rec),
            stages[level],
            lambda ch: rap_stream(ch, [len(b) for b in blocks],
                                  dd.ZLIB_HEADER)
            + _trailer(data),
            "host_rap", after=("header_splice",) if level == 2 else ())
        if stream != c:
            raise AssertionError(f"{label}: staged device tier stream "
                                 f"differs from the API's")
        print(f"[zlib{level}] stage times, ms (min of 3; device events; "
              f"host_rap on the host clock"
              + ("; header_splice = the host's headers and body splices "
                 "after the fetch" if level == 2 else "") + "): "
              + fmt_stages(stage))

    # the host deflate at levels 1 and 6 on the same corpus
    for level in (1, 6):
        hh = act.setup("zlib", level=level)
        ch, ch_s = best_s(lambda: act.compress(hh, data), 2)
        bs = act.get_codec("zlib")._block_size(hh, level)
        print(f"[zlib host] setup('zlib', level={level}) (host tier, {bs} B "
              f"blocks): {len(ch)} B, ratio "
              f"{len(data) / len(ch):.4f}, {mb / ch_s:.2f} MB/s (best of 2)")

    # the launches and device time of the dynamic path's two
    # _kraft_lengths calls (the kernel path), on the histograms the dynamic
    # encoder builds from the corpus
    arr8 = torch.from_numpy(np.frombuffer(data, np.uint8).reshape(N, B)
                            .copy()).to(dev)
    lens = torch.full((N,), B, dtype=torch.int32, device=dev)
    enc = dd.make_encoder_dyn(B, 4)
    h288, h32 = capture(dd, "_kraft_lengths", lambda: enc(arr8, lens))
    kl = lambda: (dd._kraft_lengths(*h288),  # noqa: E731
                  dd._kraft_lengths(*h32))
    ops = device_ops(kl)[0].values()
    kl_ms = wall_ms(kl)
    print(f"[zlib2] _kraft_lengths for 288 + 32 symbols (N={N}; the kernel "
          f"path): {sum(c for c, _ in ops)} device launches, "
          f"{sum(us for _, us in ops) / 1e3:.3f} ms device time (profiler), "
          f"{kl_ms:.3f} ms host clock with a synchronise (best of 20)")

    # the kernel kraft_absorb against its plain loop: the whole batch's
    # real absorb inputs of the dynamic encoder (288 and 32 symbols), then
    # seeded adversarial rows
    a288, a32 = capture(dd, "_kraft_absorb", lambda: enc(arr8, lens))
    del arr8
    kraft = {}
    for nsym, a in ((288, a288), (32, a32)):
        label = f"kraft_absorb at {nsym} symbols"
        kraft[nsym] = check_rows(
            "entropy kernel", label, dd._kraft_absorb,
            dd._kraft_absorb_plain, a, kraft_bytes(a[0]),
            kraft_steps(a[0], dd._kraft_absorb(*a)[0]))
        entropy_phases(label, "kraft_absorb", a, kraft[nsym]["ms"])
        err = kraft_adversarial(
            label, dd,
            lambda: dd._kraft_lengths(kraft_hists(nsym, nsym), nsym), dev)
        kraft[nsym]["max_abs_err"] = max(kraft[nsym]["max_abs_err"], err)
    kraft[288]["max_abs_err"] = max(kraft[288]["max_abs_err"],
                                    kraft_direct(dev))
    kraft[288]["launches"] = kraft_launches
    dlaunches, inflate = phase_inflate(data, streams, dev)
    return total, dlaunches, inflate, kraft


INFLATE_SLICE = 8   # lanes the plain scan runs on (it launches per step)


def phase_inflate(data: bytes, streams, dev):
    """Device inflate (set_config(device_decode=True)) of the zlib level 1
    and 2 streams through the API, beside the host decoder; the chunks on
    each route and the stages of each decode; then inflate_symbol_scan
    against its plain version on the batch's real inputs. Returns
    (compact_rows launches, the kernel's stats)."""
    import aocl_compression_tpu_torch as act
    from aocl_compression_tpu_torch.codecs.zlib_bzip2_lzma import (
        _inflate_host)
    from aocl_compression_tpu_torch.ops import inflate_device as idev
    from aocl_compression_tpu_torch.ops import inflate_scan
    from aocl_compression_tpu_torch.runtime import native

    mb = len(data) / 1e6
    total = scans = 0
    for level, c in streams.items():
        h = act.setup("zlib", level=level, opt_var=2)
        act.set_config(device_decode=True)
        try:
            d, d_s, launches, peak_gb = run_path(
                f"decode zlib{level}", lambda: act.decompress(h, c),
                ("zlib_decompress_blocks_torch", "fetch_chunks_kernel"))
        finally:
            act.set_config(device_decode=False)
        n_scan = inflate_scan.launches["inflate_symbol_scan"]
        if d != data:
            raise AssertionError(f"zlib{level}: device inflate did not "
                                 f"return the input")
        if launches != 2 * 3 or n_scan != 3:
            raise AssertionError(f"decode zlib{level}: the compaction or "
                                 f"the inflate kernel did not launch once "
                                 f"per call")
        total += launches
        scans += n_scan
        _, h_s = best_s(lambda: act.decompress(h, c))
        offs, lens_, dlens = native.rap_parse(c)
        chunks = [c[int(o):int(o) + int(n)] for o, n in zip(offs, lens_)]
        dl = [int(x) for x in dlens]
        rejects = sum(native.inflate_plan(x) is None for x in chunks)
        hosted = []

        def host_count(chunk, dlen):
            hosted.append(dlen)
            return _inflate_host(chunk, dlen)

        stage, passes, got = seq_stages(lambda rec: idev.decode_chunks(
            chunks, dl, device=dev, host_one=host_count, mark=rec))
        if b"".join(got) != data:
            raise AssertionError(f"decode zlib{level}: staged decode "
                                 f"differs")
        on_host = len(hosted) // 3
        print(f"[decode zlib{level}] {len(c)} B stream: device inflate "
              f"{mb / d_s:.2f} MB/s (best of 3, {d_s * 1e3:.2f} ms), host "
              f"decoder {mb / h_s:.2f} MB/s (best of 3); exact; chunks: "
              f"{len(chunks) - on_host} on the card, {rejects} planner "
              f"rejects and {on_host - rejects} multi-block or short "
              f"decodes on the host; {len(chunks) - rejects} lanes per "
              f"launch (one batch); peak device memory {peak_gb:.2f} GB; "
              f"kernel launches in 3 calls: compact_rows {launches}, "
              f"inflate_symbol_scan {n_scan}")
        print(f"[decode zlib{level}] stage times, ms (min of 3; device "
              f"events; plan = the host's first-block plans, h2d_batch = "
              f"the batch build and upload, host = the host route after "
              f"the fetch; {passes} resolve passes): " + fmt_stages(stage))

    # the kernel on the level-1 batch's real inputs
    args = capture(idev, "_scan_compact", lambda: idev.decode_chunks(
        chunks, dl, device=dev, host_one=_inflate_host))[0]
    cut = [t[:INFLATE_SLICE] for t in args[:10]] + list(args[10:])
    B_, MAXSEQ = args[10:]

    def plain(cb, bo, *rest):
        p, (b_, m_) = rest[:8], rest[8:]
        return idev._compact_plain(*idev._symbol_scan_plain(
            idev._bytes_to_words(cb), bo, *p, b_ + idev._SCAN_PAD), b_, m_)

    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = plain(*cut)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    got = inflate_scan.inflate_symbol_scan(*cut)
    torch.cuda.synchronize()
    err = check_equal("inflate_symbol_scan", got, want)
    adv = inflate_adversarial(idev)
    got = inflate_scan.inflate_symbol_scan(*(
        a.to(dev) if torch.is_tensor(a) else a for a in adv))
    torch.cuda.synchronize()
    err = max(err, check_equal("inflate_symbol_scan (adversarial batch)",
                               [g.cpu() for g in got],
                               idev._scan_compact(*adv)))
    ms = graph_ms(lambda: inflate_scan.inflate_symbol_scan(*args),
                  reps=3, replays=5)
    full = inflate_scan.inflate_symbol_scan(*args)
    n_lanes, C = args[0].shape
    ok = [x for x in chunks if native.inflate_plan(x) is not None]
    nbytes = (sum(len(x) for x in ok) + n_lanes * 4 * (1 + 6 * 16 + 288 + 32)
              + n_lanes * B_ + 3 * 4 * n_lanes * MAXSEQ + 8 * n_lanes)
    steps = int(torch.clamp(full[4] + full[5] + 1, max=B_ + 4).max())
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[decode kernel] inflate_symbol_scan vs plain on the zlib1 "
          f"batch's first {INFLATE_SLICE} lanes and on an adversarial batch "
          f"of 8 lanes (seeded: random streams, random / incomplete / "
          f"over-subscribed codes up to 15 bits, a position past the row, "
          f"the b + 4 step cap, more matches than MAXSEQ, no distance "
          f"codes): equal on every output (litbuf, ll, ml, off, nbseq, "
          f"litregen); kernel {ms:.4f} ms on the whole batch of {n_lanes} "
          f"lanes x C={C}, B={B_} (CUDA-graph replay), plain version "
          f"{plain_ms:.2f} ms on the {INFLATE_SLICE}-lane slice (one call, "
          f"device events), bound {bound_ms:.4f} ms ({nbytes} B at 3.35 "
          f"TB/s), longest lane {steps} serial steps")
    st = per_step("decode kernel", "inflate_symbol_scan",
                  lambda: inflate_scan.inflate_symbol_scan(*args), ms, steps)
    return total, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, steps=steps, launches=scans, **st)


def inflate_adversarial(idev, seed: int = 3):
    """A small corrupt and edge batch for inflate_symbol_scan, from a seed
    with numpy as in tests/test_torch_inflate.py's card tests: 8 lanes of
    C = 2048 random bytes, B = 1024, MAXSEQ = 40, as CPU tensors and
    widths. Lane 0: static codes; 1: random code ranges per length and a
    rank past int32; 2 / 3: incomplete / over-subscribed code lengths (up
    to 15 bits: the long path); 4: a position past the row's end (clamped
    reads); 5: 1-bit literal codes (the b + 4 step cap); 6: 1-bit matches
    (more than MAXSEQ); 7: no distance codes."""
    rng = np.random.default_rng(seed)
    N, C = 8, 2048
    cb = rng.integers(0, 256, (N, C), dtype=np.uint8)
    bo = rng.integers(0, 64, N).astype(np.int32)
    bo[4] = 8 * C + 37

    def some(lo, hi, nsym):
        lens = np.zeros(nsym, np.int64)
        k = rng.integers(2, nsym)
        lens[rng.choice(nsym, k, replace=False)] = rng.integers(lo, hi, k)
        return lens

    lens_l = [np.array([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8)] * N
    lens_d = [np.full(32, 5)] * N
    lens_l[2], lens_d[2] = some(3, 16, 288), some(3, 16, 32)
    lens_l[3], lens_d[3] = some(1, 6, 288), some(1, 6, 32)
    lens_l[5] = np.zeros(288, np.int64)
    lens_l[5][[65, 200]] = 1
    lens_l[6] = np.zeros(288, np.int64)
    lens_l[6][[65, 257, 270]] = [2, 1, 2]
    lens_d[6] = np.zeros(32, np.int64)
    lens_d[6][[0, 29]] = 1
    lens_d[7] = np.zeros(32, np.int64)
    params = ([np.stack(c) for c in zip(*[idev._canon_params(x, 288)
                                          for x in lens_l])]
              + [np.stack(c) for c in zip(*[idev._canon_params(x, 32)
                                            for x in lens_d])])
    ls = np.arange(16)
    for f in (0, 4):  # lane 1: not canonical at all
        nsym = params[f + 3].shape[1]
        fc = rng.integers(-2, 1 << ls)
        lim = fc + rng.integers(-1, (1 << ls) // 2 + 2)
        lim[:rng.integers(1, 9)] = 0
        params[f][1], params[f + 1][1] = fc, lim
        params[f + 2][1] = rng.integers(-40, nsym + 40, 16)
        params[f + 3][1] = rng.integers(-20, nsym + 12, nsym)
    params[0][1, 5], params[1][1, 5], params[2][1, 5] = -5, 40, (1 << 31) - 1
    return ([torch.from_numpy(cb), torch.from_numpy(bo)]
            + [torch.from_numpy(p.astype(np.int32)) for p in params]
            + [1024, 40])


def phase_bzip2_lzma(data: bytes, dev):
    """setup("bzip2", level=9) and setup("lzma", level=6), host beside
    device (opt_var=2: the device block sort, the match-finder assist),
    one call each."""
    import bz2
    import lzma

    import aocl_compression_tpu_torch as act
    from aocl_compression_tpu_torch.codecs.zlib_bzip2_lzma import (
        _bzip2_compress_torch, _lzma_compress_torch)

    mb = len(data) / 1e6
    cases = (("bzip2", 9, bz2.decompress,
              lambda rec: _bzip2_compress_torch(data, 9, dev, mark=rec)),
             ("lzma", 6,
              lambda c: lzma.decompress(c, format=lzma.FORMAT_ALONE),
              lambda rec: _lzma_compress_torch(data, 6, dev, mark=rec)))
    for method, level, stdlib, staged_run in cases:
        hh = act.setup(method, level=level)
        ch, ch_s = best_s(lambda: act.compress(hh, data), 1)
        if stdlib(ch) != data or act.decompress(hh, ch) != data:
            raise AssertionError(f"{method}: host tier round trip failed")
        h = act.setup(method, level=level, opt_var=2)
        c, c_s, _, peak_gb = run_path(
            method, lambda: act.compress(h, data),
            (f"{method}_compress_torch",), calls=1)
        if act.decompress(h, c) != data or stdlib(c) != data:
            raise AssertionError(f"{method}: the device tier's stream does "
                                 f"not round-trip through the API and the "
                                 f"stdlib")
        print(f"[{method}] setup('{method}', level={level}) (host): "
              f"{len(ch)} B, ratio {len(data) / len(ch):.4f}, "
              f"{mb / ch_s:.2f} MB/s; setup('{method}', level={level}, "
              f"opt_var=2) on {h.device}: {len(c)} B, ratio "
              f"{len(data) / len(c):.4f}, {mb / c_s:.2f} MB/s (one call "
              f"each, after a warm-up call of the device tier); both read "
              f"back by the API and the stdlib; peak device memory "
              f"{peak_gb:.2f} GB")
        check_pinned(f"{method} level {level}",
                     act.compress(h, data[:PINNED_BLOCKS * B]))
        if method == "lzma":
            check_matches("lzma 6 assist", lambda: act.compress(h, data))
        stage, _, out = seq_stages(staged_run, calls=1)
        if out != c:
            raise AssertionError(f"{method}: staged device tier stream "
                                 f"differs from the API's")
        print(f"[{method}] stage times, ms (one call; device events, the "
              f"host stages on the host clock"
              + ("; bwt = every block's device sort and its L fetch, "
                 "prepare / emit = the host's RLE1 + CRC and MTF + Huffman"
                 if method == "bzip2" else
                 "; range_code = the host's lzma_compress_cand") + "): "
              + fmt_stages(stage))


def seq_stages(run, calls=3):
    """run(rec) `calls` times, rec(stage) recording a CUDA event at each
    stage mark in order: ({stage: [ms per call]}, resolve passes of the last
    call, its result). The time between two marks is charged to the later
    one, summed where a name repeats (the two fetches of the zstd encoder,
    the resolve passes); a stage after a fetch's d2h is host work (the
    stream is idle, so the events read the host's clock)."""
    stage = {}
    for _ in range(calls):
        evs = []

        def rec(k):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            evs.append((k, ev))

        res = run(rec)
        torch.cuda.synchronize()
        per = {}
        for (_, ea), (b, eb) in zip(evs, evs[1:]):
            per[b] = per.get(b, 0.0) + ea.elapsed_time(eb)
        for k, v in per.items():
            stage.setdefault(k, []).append(v)
    passes = sum(1 for k, _ in evs if k == "resolve_pass")
    return stage, passes, res


def capture(module, name, run):
    """The arguments of every module.name(...) call while run() runs."""
    seen = []
    orig = getattr(module, name)

    def wrapped(*args):
        seen.append(args)
        return orig(*args)

    setattr(module, name, wrapped)
    try:
        run()
    finally:
        setattr(module, name, orig)
    return seen


SCAN_SLICE = 16   # blocks the plain loops run on (they launch per step)


def check_scan(label, kernel, plain, args, cut, compare, bound):
    """A scan kernel against its plain loop on the first SCAN_SLICE blocks
    of the batch's real inputs, and the kernel's graph-replay time on the
    whole batch: dict(max_abs_err, ms, plain_ms, bound_ms, steps)."""
    sl = cut(args)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = plain(*sl)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    got = kernel(*sl)
    torch.cuda.synchronize()
    err = compare(got, want)
    if err:
        raise AssertionError(f"{label} differs from its plain loop: "
                             f"max_abs_err {err}")
    ms = graph_ms(lambda: kernel(*args), reps=3, replays=5)
    nbytes, steps = bound(args)
    print(f"[zstd kernel] {label} vs plain on the batch's first {SCAN_SLICE}"
          f" blocks: equal; kernel {ms:.4f} ms on the whole batch "
          f"(CUDA-graph replay), plain loop {plain_ms:.2f} ms on the "
          f"{SCAN_SLICE}-block slice (one call, device events), bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} B at 3.35 "
          f"TB/s), longest lane {steps} serial steps")
    st = per_step("zstd kernel", label, lambda: kernel(*args), ms, steps)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, steps=steps, **st)


ADV_MAXSEQ = 600   # the adversarial sequence batch's slots: below nbseq


def seq_adversarial(args, seed: int = 4):
    """A corrupt and edge batch for fse_sequence_scan, from a seed with
    numpy as in tests/test_torch_zstd_decode.py's card tests: the first 16
    blocks of the batch's real inputs (args[:7] = qbytes, qlens, nbseq,
    fsetab, lllog, oflog, mllog) as CPU tensors, scanned at ADV_MAXSEQ
    slots (below most blocks' nbseq). Lanes 0-3: three bit flips in the
    section; 4-7: qlens 0, 1, the full row and past it, over random bytes;
    8-9: next-state bases and table logs that put states outside [0, 512);
    10-11: state reads 0-40 bits wide (the cold path); 12: nbseq below
    0."""
    rng = np.random.default_rng(seed)
    q, ql, nb, fse, *logs = [t[:SCAN_SLICE].cpu().numpy().copy()
                             for t in args[:7]]
    QB = q.shape[1]
    for i in range(4):
        for k in rng.integers(0, max(int(ql[i]), 1), 3):
            q[i, k] ^= np.uint8(1 << rng.integers(0, 8))
    q[4:8] = rng.integers(0, 256, (4, QB), dtype=np.uint8)
    ql[4:8] = [0, 1, QB, QB + 5]
    base = rng.integers(-600, 1200, fse[8:10].shape)
    fse[8:10] = (base << 16) | (fse[8:10] & 0xFFFF)
    for lg in logs:
        lg[8:10] = rng.integers(-3, 13, 2)
    wide = rng.integers(0, 41, fse[10:12].shape)
    fse[10:12] = (fse[10:12] & ~0xFF00) | (wide << 8)
    nb[12] = -3
    return [torch.from_numpy(a) for a in [q, ql, nb, fse] + logs]


def enc_adversarial(args, seed: int = 5):
    """A corrupt and edge batch for fse_encode_scan, from a seed with numpy
    as in tests/test_torch_zstd.py's card tests: the first 16 blocks of the
    batch's real inputs (xs, nseq, nxt, dnb, dfs) as CPU tensors, cut to
    ADV_MAXSEQ sequences. Lanes 0-3: nseq 0, 1, ADV_MAXSEQ and below 0;
    4-5: codes c - 64 (they count from the end of a table) on a quarter of
    the rows; 6-7: codes in [-300, 300); 8-9: dnb / dfs over the whole
    int32 range (bit counts outside [0, 32), sums that wrap); 10-11: next
    states over it (indices outside [0, 512))."""
    rng = np.random.default_rng(seed)
    xs, nseq, nxt, dnb, dfs = [t[:SCAN_SLICE].cpu().numpy().copy()
                               for t in args]
    xs = np.ascontiguousarray(xs[:, :ADV_MAXSEQ])
    nseq = np.minimum(nseq, ADV_MAXSEQ)
    nseq[:4] = [0, 1, ADV_MAXSEQ, -3]
    for i in (4, 5, 6, 7):
        for col in (0, 3, 6):
            hit = rng.random(ADV_MAXSEQ) < 0.25
            wild = (xs[i, :, col] - 64 if i < 6
                    else rng.integers(-300, 300, ADV_MAXSEQ))
            xs[i, :, col] = np.where(hit, wild, xs[i, :, col])
    dnb[8:10] = rng.integers(-2**31, 2**31, dnb[8:10].shape)
    dfs[8:10] = rng.integers(-2**31, 2**31, dfs[8:10].shape)
    nxt[10:12] = rng.integers(-2**31, 2**31, nxt[10:12].shape)
    return [torch.from_numpy(a) for a in (xs, nseq, nxt, dnb, dfs)]


def lit_adversarial(args, seed: int = 6):
    """A corrupt and edge batch for huf_literal_scan, from a seed with
    numpy as in tests/test_torch_zstd_decode.py's card tests: the first 16
    blocks (64 stream lanes) of the batch's real inputs (sbytes, slens,
    counts, huftab, huflog) as CPU tensors. Lanes 0-3: three bit flips in
    the stream; 4-8: slens 0, 1, SB, SB + 5 and 2^28 + 3 over random bytes;
    9-12: hlog -1, 0, 12 and 40; 13-14: counts past MAXL and below 0;
    block 4 (lanes 16-19): half its entries read 0 or 15 bits."""
    rng = np.random.default_rng(seed)
    sb_, sl, cnt, huf, hl = [a.cpu().numpy().copy() for a in (
        args[0][:4 * SCAN_SLICE], args[1][:4 * SCAN_SLICE],
        args[2][:4 * SCAN_SLICE], args[3][:SCAN_SLICE],
        args[4][:4 * SCAN_SLICE])]
    maxl = args[5]
    SB = sb_.shape[1]
    for i in range(4):
        for k in rng.integers(0, max(int(sl[i]), 1), 3):
            sb_[i, k] ^= np.uint8(1 << rng.integers(0, 8))
    sb_[4:9] = rng.integers(0, 256, (5, SB), dtype=np.uint8)
    sl[4:9] = [0, 1, SB, SB + 5, (1 << 28) + 3]
    hl[9:13] = [-1, 0, 12, 40]
    cnt[13:15] = [maxl + 37, -5]
    hit = rng.random(huf.shape[1]) < 0.5
    huf[4] = np.where(hit, (huf[4] & ~15) | rng.choice([0, 15], hit.shape),
                      huf[4])
    return [torch.from_numpy(a) for a in (sb_, sl, cnt, huf, hl)], maxl


def max_err(got, want, live=None):
    err = 0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        if live is not None:
            d = d[live]
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def phase_zstd(data: bytes, blocks, dev):
    """setup("zstd", level=1, opt_var=2): the level-1 device encoder (G=4,
    depth 8, nw 16, per-block Huffman and FSE tables) and, with device
    decode on, the device decoder; the three scan kernels against their
    plain loops on the batch's real inputs."""
    import aocl_compression_tpu_torch as act
    from aocl_compression_tpu_torch.codecs.zstd import (_device_frames,
                                                        _host_decode)
    from aocl_compression_tpu_torch.ops import entropy_scan
    from aocl_compression_tpu_torch.ops.deflate_device import (
        _kraft_absorb_plain)
    from aocl_compression_tpu_torch.ops import zstd_decode_device as zdd
    from aocl_compression_tpu_torch.ops import zstd_device as zd
    from aocl_compression_tpu_torch.ops import zstd_scan
    from aocl_compression_tpu_torch.runtime import native

    mb = len(data) / 1e6
    method, kw = PINNED_CALLS["zstd level 1"]
    h = act.setup(method, block_size=B, **kw)
    c, c_s, launches, peak_gb = run_path(
        "zstd", lambda: act.compress(h, data),
        ("zstd_compress_blocks_multi", "fetch_chunks_kernel"),
        per_call={"fetch_chunks_kernel": 2})
    enc = dict(zstd_scan.launches)
    ent = dict(entropy_scan.launches)
    if (launches != 2 * 2 * 3 or enc["fse_encode_scan"] != 3
            or ent != {"kraft_absorb": 3, "weights_fse_encode": 3}):
        raise AssertionError(f"zstd: the compaction (2 fetches), the FSE "
                             f"scan kernel or the entropy-table kernels "
                             f"({ent}) did not launch once per call")
    d, d_s = best_s(lambda: act.decompress(h, c))
    if d != data or native.zstd_decompress(c) != data:
        raise AssertionError("zstd: host decode did not return the input")
    hh = act.setup("zstd", level=1, block_size=B)
    ch, ch_s = best_s(lambda: act.compress(hh, data))
    print(f"[zstd] setup('zstd', level=1, opt_var=2, block_size={B}) on "
          f"{h.device}: {len(data)} B -> {len(c)} B, ratio "
          f"{len(data) / len(c):.4f} (host tier at level 1: {len(ch)} B, "
          f"ratio {len(data) / len(ch):.4f}, {mb / ch_s:.2f} MB/s, best of "
          f"3); compress {mb / c_s:.2f} MB/s (best of 3, {c_s * 1e3:.2f} "
          f"ms); host decode {mb / d_s:.2f} MB/s; round trip exact through "
          f"the API and the host decoder; peak device memory {peak_gb:.2f} "
          f"GB; kernel launches in 3 calls: compact_rows {launches}, "
          f"fse_encode_scan {enc['fse_encode_scan']}, kraft_absorb "
          f"{ent['kraft_absorb']}, weights_fse_encode "
          f"{ent['weights_fse_encode']}")
    check_pinned("zstd level 1", act.compress(h, data[:PINNED_BLOCKS * B]))
    STREAMS["zstd level 1"] = c
    check_matches("zstd 1", lambda: act.compress(h, data))

    stage, _, frames = seq_stages(
        lambda rec: _device_frames(blocks, 1, dev, mark=rec))
    if rap_zstd(frames, blocks) != c:
        raise AssertionError("zstd: staged device tier stream differs from "
                             "the API's")
    print("[zstd] stage times, ms (min of 3; device events; the fetch "
          "stages sum both fetches; assemble = the host's frames after the "
          "fetches): " + fmt_stages(stage))

    # device decode through the API, beside the host decoder
    act.set_config(device_decode=True)
    try:
        dd, dd_s, dlaunches, dpeak_gb = run_path(
            "decode zstd", lambda: act.decompress(h, c),
            ("zstd_decompress_blocks_torch", "fetch_chunks_kernel"))
    finally:
        act.set_config(device_decode=False)
    dec = dict(zstd_scan.launches)
    if dd != data:
        raise AssertionError("zstd: device decode did not return the input")
    if (dlaunches != 2 * 3 or dec["huf_literal_scan"] != 3
            or dec["fse_sequence_scan"] != 3):
        raise AssertionError("decode zstd: a kernel did not launch once per "
                             "call")
    offs, lens_, dlens = native.rap_parse(c[8:])
    chunks = [c[8 + int(o):8 + int(o) + int(n)] for o, n in zip(offs, lens_)]
    dl = [int(x) for x in dlens]
    hosted = []

    def host_count(frame):
        hosted.append(len(frame))
        return _host_decode(frame)

    stage, passes, got = seq_stages(lambda rec: zdd.decode_chunks(
        chunks, dl, device=dev, host_decode=host_count, mark=rec))
    if b"".join(got) != data:
        raise AssertionError("decode zstd: staged decode differs")
    print(f"[decode zstd] {len(c)} B stream: device decode {mb / dd_s:.2f} "
          f"MB/s (best of 3, {dd_s * 1e3:.2f} ms), host decoder "
          f"{mb / d_s:.2f} MB/s (best of 3); exact; {len(chunks) - len(hosted) // 3}"
          f" of {len(chunks)} frames on the device, {len(hosted) // 3} to the"
          f" host decoder (raw blocks, or raw literals past the stream "
          f"cap); peak device memory {dpeak_gb:.2f} GB; kernel launches in 3 "
          f"calls: compact_rows {dlaunches}, huf_literal_scan "
          f"{dec['huf_literal_scan']}, fse_sequence_scan "
          f"{dec['fse_sequence_scan']}")
    print(f"[decode zstd] stage times, ms (min of 3; device events; plan = "
          f"the host's frame plans; {passes} resolve passes): "
          + fmt_stages(stage))

    # the scan kernels on the batch's real inputs
    enc_args = capture(zd, "_fse_scan", lambda: zd.encode_blocks(
        blocks, 1, device=dev))[0]
    lit_args = capture(zdd, "_literal_scan", lambda: zdd.decode_chunks(
        chunks, dl, device=dev, host_decode=_host_decode))[0]
    seq_args = capture(zdd, "_sequence_scan", lambda: zdd.decode_chunks(
        chunks, dl, device=dev, host_decode=_host_decode))[0]
    k = SCAN_SLICE
    stats = {}

    def fse_bound(a):
        xs, nseq, nxt, dnb, dfs = a
        n_, maxseq = xs.shape[:2]
        used = int(nseq.sum())
        nbytes = (used * 8 * 4 + 4 * n_ + 4 * (nxt[0].numel() + dnb[0].numel()
                                              + dfs[0].numel()) * n_
                  + 2 * n_ * maxseq * 6 * 4 + n_ * 3 * 4)
        return nbytes, int(nseq.max())

    stats["fse_encode_scan"] = check_scan(
        "fse_encode_scan", zd._fse_scan, zd._fse_scan_plain, enc_args,
        lambda a: [t[:k] for t in a], max_err, fse_bound)

    L = lit_args[0].shape[0]
    maxl = lit_args[5]

    def lit_cut(a):
        return [t[:4 * k] for t in a[:3]] + [a[3][:k], a[4][:4 * k], a[5]]

    def lit_cmp(got, want):
        live = (torch.arange(maxl, device=dev)[None]
                < torch.clamp(lit_args[2][:4 * k], max=maxl)[:, None])
        return max_err([got], [want], live)

    def lit_bound(a):
        cnt = torch.clamp(a[2], max=maxl)
        nbytes = (int(a[1].sum()) + 3 * 4 * L + a[3].numel() * 4
                  + int(cnt.sum()))
        return nbytes, int(cnt.max())

    stats["huf_literal_scan"] = check_scan(
        "huf_literal_scan", zdd._literal_scan, zdd._literal_scan_plain,
        lit_args, lit_cut, lit_cmp, lit_bound)

    def seq_cut(a):
        return [t[:k] for t in a[:7]] + [a[7]]

    def seq_bound(a):
        n_, maxseq = a[0].shape[0], a[7]
        nbytes = (int(a[1].sum()) + 2 * 4 * n_ + a[3].numel() * 4
                  + 3 * 4 * n_ + 3 * 4 * n_ * maxseq)
        return nbytes, int(a[2].max())

    stats["fse_sequence_scan"] = check_scan(
        "fse_sequence_scan", zdd._sequence_scan, zdd._sequence_scan_plain,
        seq_args, seq_cut, max_err, seq_bound)
    adv = seq_adversarial(seq_args)
    got = zdd._sequence_scan(*(a.to(dev) for a in adv), ADV_MAXSEQ)
    check_equal("fse_sequence_scan (adversarial batch)",
                [g.cpu() for g in got],
                zdd._sequence_scan_plain(*adv, ADV_MAXSEQ))
    print(f"[zstd kernel] fse_sequence_scan vs plain on an adversarial "
          f"batch of {SCAN_SLICE} blocks at MAXSEQ {ADV_MAXSEQ} (seeded: "
          f"mutated sections, qlens 0 / 1 / the full row / past it, states "
          f"outside [0, 512), state reads up to 40 bits, nbseq past MAXSEQ "
          f"and below 0): equal on every slot")
    adv = enc_adversarial(enc_args)
    got = zd._fse_scan(*(a.to(dev) for a in adv))
    check_equal("fse_encode_scan (adversarial batch)",
                [g.cpu() for g in got], zd._fse_scan_plain(*adv))
    print(f"[zstd kernel] fse_encode_scan vs plain on an adversarial batch "
          f"of {SCAN_SLICE} blocks at MAXSEQ {ADV_MAXSEQ} (seeded: nseq 0 / "
          f"1 / MAXSEQ / below 0, codes outside [0, 64) and negative, dnb / "
          f"dfs / next states over the int32 range): equal on every output")
    adv, adv_maxl = lit_adversarial(lit_args)
    got = zdd._literal_scan(*(a.to(dev) for a in adv), adv_maxl).cpu()
    want = zdd._literal_scan_plain(*adv, adv_maxl)
    live = (torch.arange(adv_maxl)[None]
            < torch.clamp(adv[2], max=adv_maxl)[:, None])
    if not torch.equal(got[live], want[live]):
        raise AssertionError("huf_literal_scan (adversarial batch) differs "
                             "from its plain version")
    print(f"[zstd kernel] huf_literal_scan vs plain on an adversarial batch "
          f"of {4 * SCAN_SLICE} stream lanes at MAXL {adv_maxl} (seeded: "
          f"mutated streams, slens 0 / 1 / SB / SB + 5 / 2^28 + 3, hlog -1 / "
          f"0 / 12 / 40, counts past MAXL and below 0, entries of 0 and 15 "
          f"bits): equal on every slot below each lane's count")
    for name in stats:
        stats[name]["launches"] = enc.get(name, 0) + dec.get(name, 0)

    # the entropy-table kernels on the batch's real inputs (the encoder's
    # absorb at 256 symbols and its weight rows), then seeded adversarial
    # rows
    def encode():
        return zd.encode_blocks(blocks, 1, device=dev)

    kargs = capture(zd, "_kraft_absorb", encode)[0]
    wargs = capture(zd, "_encode_weights", encode)[0]
    n_ = wargs[0].shape[0]
    entropy = {
        "kraft_absorb": check_rows(
            "entropy kernel", "kraft_absorb at 256 symbols",
            zd._kraft_absorb, _kraft_absorb_plain, kargs,
            kraft_bytes(kargs[0]),
            kraft_steps(kargs[0], zd._kraft_absorb(*kargs)[0])),
        "weights_fse_encode": check_rows(
            "entropy kernel", "weights_fse_encode (the longest lane: state "
            "1's init and 127 steps)", zd._encode_weights,
            zd._encode_weights_plain, wargs,
            n_ * (255 * 4 + entropy_scan.WCAP + 4) + (64 + 2 * 12) * 4,
            128)}
    c = zd._consts(dev)
    for name, args in (("kraft_absorb", kargs),
                       ("weights_fse_encode",
                        (wargs[0].contiguous(), c["w_nxt"], c["w_dnb"],
                         c["w_dfs"]))):
        entropy_phases(f"{name} (zstd 1)", name, args, entropy[name]["ms"])
    lits, nl = lit_rows_adversarial()
    err = kraft_adversarial("kraft_absorb at 256 symbols", zd,
                            lambda: zd._block_huffman(lits, nl), dev)
    entropy["kraft_absorb"]["max_abs_err"] = max(
        entropy["kraft_absorb"]["max_abs_err"], err)
    _, _, w, ok = zd._block_huffman(lits, nl)
    wadv = weight_rows_adversarial(w[ok])
    got = zd._encode_weights(wadv.to(dev))
    check_equal("weights_fse_encode (adversarial rows)",
                [g.cpu() for g in got], zd._encode_weights_plain(wadv))
    print(f"[entropy kernel] weights_fse_encode vs plain on "
          f"{wadv.shape[0]} seeded adversarial rows (the weights of the "
          f"adversarial literal rows, all 0, all 11, alternating 0 / 11, a "
          f"ramp, random): equal on every output")
    for name in entropy:
        entropy[name]["launches"] = ent[name]
    return launches + dlaunches, stats, entropy


def counted(label, fn, hits_want):
    """One fn() call with the audit on and every kernel count set to 0 just
    before: (result, s, compact_rows launches, audit hits). Fails unless
    every audit name in hits_want ({name: hits}) was hit that often."""
    from aocl_compression_tpu_torch.ops import compact
    from aocl_compression_tpu_torch.utils import dispatch
    torch.cuda.synchronize()
    dispatch.enable_audit(True)
    reset_counts()
    try:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        launches = compact.launches
        hits = dispatch.audit_hits()
    finally:
        dispatch.enable_audit(False)
    chain = tally_paths()
    print(f"[{label}] dispatch audit: {json.dumps(hits, sort_keys=True)}; "
          f"compact_rows launches: {launches}; chain, match and emit "
          f"kernels' launches: {json.dumps(chain)}")
    for name, want in hits_want.items():
        if hits.get(name) != want:
            raise AssertionError(f"{label}: {name} was hit "
                                 f"{hits.get(name)} times, not {want}")
    return res, t, launches, hits


def check_surface_pin(label, stream):
    """A host-surface call's bytes on the first PINNED_BLOCKS blocks against
    the JAX package's sha256 (PINNED_SURFACE_SHA256)."""
    digest = hashlib.sha256(stream).hexdigest()
    if digest != PINNED_SURFACE_SHA256[label]:
        raise AssertionError(f"{label}: the {PINNED_BLOCKS}-block output's "
                             f"sha256 {digest} is not the JAX package's "
                             f"{PINNED_SURFACE_SHA256[label]}")
    print(f"[surface] {label}, first {PINNED_BLOCKS} blocks: {len(stream)} "
          f"B, sha256 {digest} = the JAX package's")


def pieces(data: bytes, seed: int, most: int):
    """data cut into seeded random sizes in [1, most]."""
    rng = np.random.default_rng(seed)
    out, pos = [], 0
    while pos < len(data):
        k = int(rng.integers(1, most + 1))
        out.append(data[pos:pos + k])
        pos += k
    return out


def trace_names(fn, tries: int = 5):
    """The event names of the Chrome trace profiling.trace writes around
    fn(), and the windows lost. A window that holds no device event at all
    is profiled again (up to `tries`), as in device_ops."""
    import glob
    import os
    import tempfile

    from aocl_compression_tpu_torch.utils import profiling
    for lost in range(tries):
        with tempfile.TemporaryDirectory() as td:
            with profiling.trace(td):
                fn()
            (path,) = glob.glob(os.path.join(td, "*.json"))
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        if any(e.get("cat") == "kernel" for e in events):
            return {e.get("name", "") for e in events}, lost
    raise AssertionError(f"the profiler's trace held no device event in "
                         f"{tries} windows")


def phase_surface(data: bytes, dev):
    """The host surface on the card: the LZ4 frame at the device tier,
    native_api.LZ4_compress_fast(acceleration 2), every stream codec, .xz,
    dictionaries, the bench CLI and a profiler trace. Returns
    {path: compact_rows launches}."""
    import bz2
    import contextlib
    import gzip
    import io
    import lzma
    import os
    import tempfile
    import zlib

    import aocl_compression_tpu_torch as act
    from aocl_compression_tpu_torch import native_api
    from aocl_compression_tpu_torch.codecs import lz4_frame, xz, zstd
    from aocl_compression_tpu_torch.ops import compact
    from aocl_compression_tpu_torch.ops import lz4_device as ld
    from aocl_compression_tpu_torch.tools import bench_cli
    from aocl_compression_tpu_torch.utils import profiling
    from aocl_compression_tpu_torch.utils.config import TIER_TORCH

    mb = len(data) / 1e6
    pin = data[:PINNED_BLOCKS * B]
    nblk = -(-len(data) // B)
    paths = {}

    def frame(d, **kw):
        return lz4_frame.compress_frame(d, max_tier=TIER_TORCH, device=dev,
                                        **kw)

    # the frame at the device tier: one device call (one compact_rows) per
    # 64 KiB frame block. The pinned blocks' frame, with block checksums on
    # and off, round trips through decompress_frame and DecompressStream
    # and holds the JAX package's bytes; best of 3 there.
    for bchk in (False, True):
        f, f_s, launches, _ = counted(
            f"surface frame, {PINNED_BLOCKS} blocks, block_checksum={bchk}",
            lambda: frame(pin, block_checksum=bchk),
            {"lz4_compress_torch": 1, "fetch_chunks_kernel": PINNED_BLOCKS})
        if launches != 2 * PINNED_BLOCKS:
            raise AssertionError("frame: compact_rows did not launch its two "
                                 "kernels once per frame block")
        ds = act.DecompressStream("lz4")
        back = b"".join(ds.write(p) for p in pieces(f, 1, 4096)) + ds.finish()
        if lz4_frame.decompress_frame(f) != pin or back != pin:
            raise AssertionError("frame: round trip failed")
        if not bchk:
            check_surface_pin("lz4 frame", f)
    _, pin_s = best_s(lambda: frame(pin))
    # one call's compaction inputs at the frame path's shape (N = 1)
    seen = capture(compact, "compact_rows_kernel", lambda: frame(pin[:B]))
    frame_err = check_compact(compact, "the frame path, one frame block",
                              *seen[0])[1]
    # its chain marking at the same shape (the greedy parse of one 64 KiB
    # block at acceleration 1: N = 1 x 65,536, most of chain_marks'
    # launches), against the plain version, timed beside its bound
    check_marks("the frame path, one frame block",
                *capture(ld, "_chain_marks", lambda: frame(pin[:B]))[0])
    # and its match finder (N = 1 x 65,536)
    check_matches("the frame path, one frame block", lambda: frame(pin[:B]))

    # the whole corpus once (256 device calls), beside the host-tier frame
    # and the RAP lz4 path of phase 4
    f, f_s, paths["lz4 frame (device tier)"], _ = counted(
        "surface frame", lambda: frame(data),
        {"lz4_compress_torch": 1, "fetch_chunks_kernel": nblk})
    if paths["lz4 frame (device tier)"] != 2 * nblk:
        raise AssertionError("frame: compact_rows did not launch its two "
                             "kernels once per frame block")
    if lz4_frame.decompress_frame(f) != data:
        raise AssertionError("frame: the corpus's frame does not decode")
    fh, fh_s = best_s(lambda: lz4_frame.compress_frame(data))
    if lz4_frame.decompress_frame(fh) != data:
        raise AssertionError("frame: the host-tier frame does not decode")
    h = act.setup("lz4", opt_var=2, block_size=B)
    rap, rap_s = best_s(lambda: act.compress(h, data))
    print(f"[surface] lz4 frame at the device tier: {len(data)} B -> "
          f"{len(f)} B, ratio {len(data) / len(f):.4f}, {mb / f_s:.2f} MB/s "
          f"(one call, {f_s * 1e3:.2f} ms, {nblk} device calls); "
          f"{PINNED_BLOCKS} blocks {PINNED_BLOCKS * B / 1e6 / pin_s:.2f} MB/s "
          f"(best of 3); host-tier frame {len(fh)} B, ratio "
          f"{len(data) / len(fh):.4f}, {mb / fh_s:.2f} MB/s (best of 3); "
          f"RAP lz4 (phase 4's path) {len(rap)} B, {mb / rap_s:.2f} MB/s "
          f"(best of 3)")

    # LZ4_compress_fast(acceleration 2): the device encoder on one handle
    def fast():
        return native_api.LZ4_compress_fast(data, 2, device=dev)
    fast()
    c, c_s, paths["LZ4_compress_fast"], _ = counted(
        "surface LZ4_compress_fast", fast, {"lz4_compress_torch": 1})
    want = act.compress(act.setup("lz4", opt_var=2, enable_rap=False), data)
    if c != want:
        raise AssertionError("LZ4_compress_fast differs from setup('lz4', "
                             "opt_var=2, enable_rap=False)")
    if native_api.LZ4_decompress_safe(c, len(data), device=dev) != data:
        raise AssertionError("LZ4_compress_fast: LZ4_decompress_safe failed")
    check_surface_pin("LZ4_compress_fast",
                      native_api.LZ4_compress_fast(pin, 2, device=dev))
    print(f"[surface] LZ4_compress_fast(data, 2): {len(c)} B, ratio "
          f"{len(data) / len(c):.4f}, {mb / c_s:.2f} MB/s (one call); equal "
          f"to compress(setup('lz4', opt_var=2, enable_rap=False)); "
          f"LZ4_decompress_safe exact")

    # streams: seeded random-size writes, stock decoders where they exist,
    # and DecompressStream fed in small pieces
    stock = {"zlib": zlib.decompress, "gzip": gzip.decompress,
             "bzip2": bz2.decompress,
             "zstd": lambda s: native_api.ZSTD_decompress(s, device=dev),
             "lz4": lz4_frame.decompress_frame}
    writes = pieces(data, 2, 1 << 20)
    for codec in ("zlib", "gzip", "zstd", "bzip2", "lz4"):
        t0 = time.perf_counter()
        cs = act.CompressStream(codec)
        s = b"".join(cs.write(w) for w in writes) + cs.finish()
        cs_s = time.perf_counter() - t0
        if stock[codec](s) != data:
            raise AssertionError(f"stream {codec}: the stock decoder failed")
        t0 = time.perf_counter()
        ds = act.DecompressStream(codec)
        back = b"".join(ds.write(p) for p in pieces(s, 3, 65536)) \
            + ds.finish()
        ds_s = time.perf_counter() - t0
        if back != data:
            raise AssertionError(f"stream {codec}: DecompressStream failed")
        print(f"[surface] stream {codec}: {len(s)} B, ratio "
              f"{len(data) / len(s):.4f}; CompressStream {mb / cs_s:.2f} "
              f"MB/s, DecompressStream {mb / ds_s:.2f} MB/s (one pass each); "
              f"{'stdlib' if codec in ('zlib', 'gzip', 'bzip2') else 'port'} "
              f"decoder exact")

    # .xz: 1 MiB blocks, read by stdlib lzma, one block by random access
    t0 = time.perf_counter()
    x = xz.xz_compress(data, 6, block_size=1 << 20)
    x_s = time.perf_counter() - t0
    if lzma.decompress(x) != data:
        raise AssertionError(".xz: stdlib lzma rejected the stream")
    idx = xz.xz_index(x)
    k = len(idx) // 2
    off, _, usize = idx[k]
    if xz.xz_decompress_block(x, off) != data[k << 20:(k << 20) + usize]:
        raise AssertionError(".xz: random access to one block failed")
    print(f"[surface] xz_compress(level 6, 1 MiB blocks): {len(x)} B, ratio "
          f"{len(data) / len(x):.4f}, {mb / x_s:.2f} MB/s (one call); "
          f"stdlib lzma exact; {len(idx)} blocks in the index, block {k} by "
          f"random access exact")

    # dictionaries: trained on slices, then zstd with the dictionary
    samples = [data[i:i + 4096] for i in range(0, 8 << 20, 1 << 15)]
    d = zstd.train_dictionary(samples, 16384)
    hd = act.setup("zstd", dictionary=d, block_size=16384)
    part = data[:4 << 20]
    cd = act.compress(hd, part)
    if act.decompress(hd, cd) != part:
        raise AssertionError("zstd with a trained dictionary: round trip "
                             "failed")
    c0 = act.compress(act.setup("zstd", block_size=16384), part)
    print(f"[surface] train_dictionary: {len(d)} B from {len(samples)} "
          f"samples; zstd level 3, 16 KiB blocks, 4 MiB: {len(cd)} B with it, "
          f"{len(c0)} B without; round trip exact")

    # the bench CLI on a file of the corpus: each JSON line verified
    def cli(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = bench_cli.main(argv)
        if rc:
            raise AssertionError(f"bench CLI {argv} exited {rc}")
        return out.getvalue().splitlines()

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "corpus.bin")
        with open(path, "wb") as fh_:
            fh_.write(data)
        lines, _, paths["bench CLI -e lz4:0:2"], hits = counted(
            "surface bench CLI", lambda: cli(
                ["-e", "lz4:0:2", "-t", "-p", "--json", "--device", "cuda",
                 path]), {})
        lines += cli(["-n", "-e", "zstd", "-t", "-i", "3", "--json",
                      "--device", "cuda", path])
    # -i 10: ten compress calls, one device batch (one compact_rows) each
    if "lz4_compress_blocks_multi" not in hits or \
            paths["bench CLI -e lz4:0:2"] != 2 * 10:
        raise AssertionError("bench CLI: -e lz4:0:2 did not run the device "
                             "tier once per compress call")
    for line in lines:
        if json.loads(line).get("verify") != "OK":
            raise AssertionError(f"bench CLI: {line}")
        print(f"[surface] bench CLI: {line}")

    # a profiler trace around one device compress: the span and both
    # compaction kernels by name
    def profiled():
        with profiling.annotate("atpu-lz4-compress"):
            act.compress(h, pin)
    (names, lost), _, paths["profiled compress"], _ = counted(
        "surface profiler", lambda: trace_names(profiled), {})
    if paths["profiled compress"] != 2 * (lost + 1):
        raise AssertionError("profiled compress: compact_rows did not launch "
                             "its two kernels once per window")
    for want in ("atpu-lz4-compress", "compact_layout_kernel",
                 "compact_copy_bulk_kernel"):
        if not any(want in n for n in names):
            raise AssertionError(f"the profiler's trace holds no {want}")
    print(f"[surface] profiling.trace: the Chrome trace holds the span and "
          f"both compact_rows kernels ({lost} windows with no device event "
          f"profiled again)")
    return paths, frame_err


def in_turns(single, multi):
    """single() and multi() once each to warm up, then in turns A B B A,
    one call each (host clock); the first multi() runs with the audit on
    and every kernel count set to 0 just before: (its result, {"single":
    [s, s], "multi": [s, s]}, audit hits, compact_rows launches, the scan
    kernels' launches {name: n})."""
    from aocl_compression_tpu_torch.ops import (compact, entropy_scan,
                                                zstd_scan)
    from aocl_compression_tpu_torch.utils import dispatch
    single()
    multi()
    torch.cuda.synchronize()
    times = {"single": [best_s(single, 1)[1]]}
    dispatch.enable_audit(True)
    reset_counts()
    try:
        res, t = best_s(multi, 1)
        hits = dispatch.audit_hits()
    finally:
        dispatch.enable_audit(False)
    n, scans = compact.launches, dict(zstd_scan.launches,
                                      **entropy_scan.launches)
    tally_paths()
    times["multi"] = [t, best_s(multi, 1)[1]]
    times["single"].append(best_s(single, 1)[1])
    return res, times, hits, n, scans


def fmt_turns(mb, times):
    return (f"{mb / min(times['multi']):.2f} MB/s against the single-device "
            f"tier's {mb / min(times['single']):.2f} (best of 2, in turns A "
            f"B B A: " + ", ".join(f"{k} {[round(x * 1e3, 2) for x in v]} ms"
                                   for k, v in times.items()) + ")")


def phase_multi(data: bytes, blocks, dev):
    """13. The multi-device tier at world size 1, on the corpus: the API at
    num_shards=4 (one shard a card), four virtual shards of this card for
    the lz4 encoder, snappy, zlib 1 and 2, zstd 1 and the lz4 decoder,
    compress_blocks_distributed in a single-rank NCCL group over a 1 x 4
    host-chip mesh, and dryrun_multichip(4). Every output is held to the
    single-device tier's (phases 4 and 8-10). Returns ({path: compact_rows
    launches}, {kernel: launches} of fse_encode_scan, kraft_absorb and
    weights_fse_encode)."""
    import tempfile

    import torch.distributed as dist

    import aocl_compression_tpu_torch as act
    from aocl_compression_tpu_torch.codecs.lz4 import _device_bodies
    from aocl_compression_tpu_torch.codecs.snappy import _varint
    from aocl_compression_tpu_torch.codecs.zlib_bzip2_lzma import _trailer
    from aocl_compression_tpu_torch.ops import compact, zstd_scan
    from aocl_compression_tpu_torch.ops.deflate_device import ZLIB_HEADER
    from aocl_compression_tpu_torch.parallel import (distributed, dryrun,
                                                     sharded)
    from aocl_compression_tpu_torch.runtime import native
    from aocl_compression_tpu_torch.utils import dispatch
    from aocl_compression_tpu_torch.utils.config import TIER_MULTI, TIER_TORCH

    mb = len(data) / 1e6
    devices = [dev] * 4
    paths = {}
    ref = STREAMS["lz4"]
    sha = hashlib.sha256(ref).hexdigest()

    # 1. the API at world size 1: shards = min(4, device count)
    shards = min(4, torch.cuda.device_count())
    h = act.setup("lz4", opt_var=2, num_shards=4, block_size=B)
    c, c_s, launches, peak_gb = run_path(
        "multi api", lambda: act.compress(h, data),
        ("lz4_compress_blocks_multi", "fetch_chunks_kernel"),
        per_call={"fetch_chunks_kernel": shards})
    if c != ref or launches != 2 * shards * 3:
        raise AssertionError("multi api: the stream differs from phase 4's, "
                             "or compact_rows did not launch once a shard")
    paths["multi: API num_shards=4"] = launches
    print(f"[multi] setup('lz4', opt_var=2, num_shards=4, block_size={B}) on "
          f"{h.device}: {shards} shard(s) ({torch.cuda.device_count()} "
          f"card(s)); {len(c)} B, sha256 {hashlib.sha256(c).hexdigest()} "
          f"(phase 4: {len(ref)} B, {sha}); compress {mb / c_s:.2f} MB/s "
          f"(best of 3); peak device memory {peak_gb:.2f} GB")

    # 2. four virtual shards of this card, beside the single-device tier
    def single():
        return _device_bodies(blocks, 2, dev)

    def multi():
        return sharded.compress_blocks_multi(blocks, 2, 4, device=dev,
                                             devices=devices)

    times, peaks = {}, {}
    for name, fn in (("single", single), ("multi", multi), ("multi", multi),
                     ("single", single)):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out, t = best_s(fn)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        times.setdefault(name, []).append(t)
        if name == "multi":
            launches = compact.launches
            got = out
        else:
            want = out
    if got != (want[0], want[1]) or stitch_rap(*got, blocks) != ref:
        raise AssertionError("multi: 4 virtual shards differ from the "
                             "single-device tier")
    if launches != 2 * 4 * 3:
        raise AssertionError("multi: compact_rows did not launch once a "
                             "shard")
    paths["multi: lz4 4 virtual shards"] = launches
    check_matches("a shard of 4 virtual shards", multi)
    check_emit("a shard of 4 virtual shards", "lz4", multi)
    print(f"[multi] compress_blocks_multi(blocks, 2, num_shards=4, devices="
          f"[{dev}] * 4): bodies and tails equal phase 4's path; "
          f"compact_rows launches in 3 calls {launches}; "
          f"{mb / min(times['multi']):.2f} MB/s against the single-device "
          f"tier's {mb / min(times['single']):.2f} (best of 3, A B B A: "
          + ", ".join(f"{k} {[round(x * 1e3, 2) for x in v]} ms"
                      for k, v in times.items())
          + f"); peak device memory {peaks['multi']:.2f} GB against "
          f"{peaks['single']:.2f}")

    # 3. snappy, zlib 1 and 2, zstd 1: their MULTI variants, 4 shards,
    # beside their single-device (TORCH) variants in turns
    finish = {
        "snappy": lambda r: rap_stream(r[0], r[1], _varint(len(data))),
        "zlib level 1": lambda r: rap_stream(r[0], r[1], ZLIB_HEADER)
        + _trailer(data),
        "zlib level 2": lambda r: rap_stream(r[0], r[1], ZLIB_HEADER)
        + _trailer(data),
        "zstd level 1": lambda r: rap_zstd(r[0], blocks)}
    # each path's launches of the encoders' scan kernels, 4 shards
    scans_want = {
        "snappy": {}, "zlib level 1": {},
        "zlib level 2": {"kraft_absorb": 8},
        "zstd level 1": {"fse_encode_scan": 4, "kraft_absorb": 4,
                         "weights_fse_encode": 4}}
    counted = dict.fromkeys(("fse_encode_scan", "kraft_absorb",
                             "weights_fse_encode"), 0)
    for label, (method, kw) in PINNED_CALLS.items():
        if label not in finish:
            continue
        args = (blocks, kw.get("level", 2) if method != "snappy" else 2) + (
            (None,) if method == "zstd" else ()) + (dev,)
        r, times, hits, n, nf = in_turns(
            lambda: dispatch.resolve(method, "compress_blocks", TIER_TORCH)(
                *args),
            lambda: dispatch.resolve(method, "compress_blocks", TIER_MULTI)(
                *args, num_shards=4, devices=devices))
        got_scans = {k: nf[k] for k in counted if nf[k]}
        if got_scans != scans_want[label]:
            raise AssertionError(f"multi {label}: scan kernel launches "
                                 f"{got_scans}, want {scans_want[label]}")
        for k in got_scans:
            counted[k] += got_scans[k]
        want_n = 2 * 4 * (2 if method == "zstd" else 1)
        stream = finish[label](r)
        if stream != STREAMS[label]:
            raise AssertionError(f"multi {label}: the stream differs from "
                                 f"its phase's")
        if hits.get(f"{method}_compress_blocks_multi") != 1 or n != want_n:
            raise AssertionError(f"multi {label}: audit {hits} or "
                                 f"compact_rows launches {n}")
        paths[f"multi: {label} 4 virtual shards"] = n
        print(f"[multi] {method}_compress_blocks_multi({kw}, num_shards=4, "
              f"4 virtual shards): {len(stream)} B, equal to its phase's "
              f"stream; " + fmt_turns(mb, times) + f"; audit "
              f"{json.dumps(hits, sort_keys=True)}; compact_rows launches "
              f"{n}" + "".join(f", {k} {v}" for k, v in got_scans.items()))

    check_emit("a snappy shard of 4 virtual shards", "snappy",
               lambda: dispatch.resolve("snappy", "compress_blocks",
                                        TIER_MULTI)(blocks, 2, dev,
                                                    num_shards=4,
                                                    devices=devices))

    # 4. the lz4 decoder over 4 virtual shards (the variant device decode
    # resolves), on phase 4's stream, beside the single-device decoder
    offs, lens_, dlens = native.rap_parse(ref)
    chunks = [ref[int(o):int(o) + int(n)] for o, n in zip(offs, lens_)]
    dl = [int(x) for x in dlens]
    out, times, hits, n, _ = in_turns(
        lambda: dispatch.resolve("lz4", "decompress_blocks", TIER_TORCH)(
            chunks, dl, B, dev),
        lambda: dispatch.resolve("lz4", "decompress_blocks", TIER_MULTI)(
            chunks, dl, B, dev, num_shards=4, devices=devices))
    paths["multi: lz4 decode 4 virtual shards"] = n
    if b"".join(out) != data or hits.get("lz4_decompress_blocks_multi") != 1:
        raise AssertionError(f"multi decode: not exact, or audit {hits}")
    print(f"[multi] lz4_decompress_blocks_multi(num_shards=4, 4 virtual "
          f"shards) of phase 4's stream: exact; " + fmt_turns(mb, times)
          + f"; audit {json.dumps(hits, sort_keys=True)}; compact_rows "
          f"launches {n}")

    # 5. distributed.py in a single-rank NCCL group, 1 x 4 virtual chips:
    # one call to form the communicator, then the counted one
    bodies, tails = want
    with tempfile.TemporaryDirectory() as td:
        torch.cuda.set_device(0)   # NCCL's rank 0 runs on card 0
        dist.init_process_group(
            "nccl", init_method=f"file://{td}/store", world_size=1, rank=0,
            timeout=distributed.TIMEOUT)
        try:
            mesh = distributed.make_host_chip_mesh(1, 4, devices=devices)
            stats = {}

            def run():
                return distributed.compress_blocks_distributed(
                    blocks, B, mesh, accel=2, stats=stats)

            _, t_first = best_s(run, 1)
            reset_counts()
            (dchunks, (sizes, dtails), n_glob), t = best_s(run, 1)
            paths["multi: distributed 1 x 4"] = compact.launches
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    if (dchunks != bodies or sizes.tolist() != [len(x) for x in bodies]
            or dtails.tolist() != tails or n_glob != N
            or stats != dict(total_in=len(data),
                             total_out=int(sizes.sum()))):
        raise AssertionError("multi distributed: the tables or totals differ "
                             "from phase 4's")
    print(f"[multi] compress_blocks_distributed over a 1 x 4 host-chip mesh "
          f"of virtual shards, {backend} group of 1 rank: sizes and tails "
          f"equal phase 4's, total_in {stats['total_in']}, total_out "
          f"{stats['total_out']} (= the sizes' sum); {mb / t:.2f} MB/s (one "
          f"call, with the collectives; the group's first call, which forms "
          f"the communicator, {mb / t_first:.2f}); compact_rows launches "
          f"{paths['multi: distributed 1 x 4']}")

    # 6. dryrun_multichip on four virtual shards
    reset_counts()
    dryrun.dryrun_multichip(4, devices=devices)
    paths["multi: dryrun_multichip(4)"] = compact.launches
    return paths, counted


def rap_zstd(frames, blocks):
    """The RAP stream the zstd codec writes: the RAP frame inside a
    skippable frame, then the frames."""
    import struct

    from aocl_compression_tpu_torch.runtime import native
    offsets = np.cumsum([0] + [len(x) for x in frames[:-1]])
    rap = native.rap_write(len(frames), offsets + native.rap_frame_len(
        len(frames)), [len(x) for x in frames], [len(b) for b in blocks])
    return struct.pack("<II", 0x184D2A50, len(rap)) + rap + b"".join(frames)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import aocl_compression_tpu_torch  # noqa: F401  (fails outside the repo)
    from aocl_compression_tpu_torch.ops import lz4_device

    kind = phase_card()
    phase_build()
    t_start = time.perf_counter()

    def lap(name):
        print(f"[time] {name} done, {time.perf_counter() - t_start:.1f} s "
              f"after the build", flush=True)

    data = corpus(B * N)
    blocks = [data[i * B:(i + 1) * B] for i in range(N)]
    dev = torch.device("cuda")
    arr = torch.from_numpy(
        np.frombuffer(data, dtype=np.uint8).reshape(N, B).copy()).to(dev)
    lens = torch.full((N,), B, dtype=torch.int32, device=dev)

    # real encodes at the paths' configs give the kernel its sizes: the lz4
    # main path, lz4hc level 9, snappy's tile (G=4) and exact (G=0)
    # encoders, the static deflate encoder and the dynamic one's bodies (at
    # the sizes its fetch reads); the decoder's rows are the corpus itself
    from aocl_compression_tpu_torch.ops import deflate_device as dd
    from aocl_compression_tpu_torch.ops import snappy_device as sd
    out, sizes, _, _ = lz4_device.make_encoder(B, 4)(arr, lens)
    slices = {}

    def add_slice(label, bodies, sz):
        slices[f"{label}, N={N} x OUTCAP={bodies.shape[1]}"] = (bodies, sz)

    add_slice("the lz4hc encode",
              *lz4_device.make_encoder(B, 0, 11, 32, lazy=1)(arr, lens)[:2])
    add_slice("the decoder's full rows", arr, lens)
    add_slice("the snappy encode (G=4)", *sd.make_encoder(B, 4)(arr, lens)[:2])
    add_slice("the snappy exact encode (G=0)",
              *sd.make_encoder(B, 0)(arr, lens)[:2])
    add_slice("the static deflate encode", *dd.make_encoder(B, 4)(arr, lens))
    dyn_out, bits = dd.make_encoder_dyn(B, 4)(arr, lens)[:2]
    add_slice("the dynamic deflate bodies", dyn_out, torch.clamp(
        (bits + 7) // 8 + 1, max=dyn_out.shape[1]).to(torch.int32))
    del dyn_out, bits
    # the zstd encoder's two fetches, at the sizes encode_blocks passes
    from aocl_compression_tpu_torch.ops import zstd_device as zd
    zo = zd.make_encoder(B, 4)(arr, lens)
    scap = zd.stream_cap(B)
    slices[f"the zstd literal streams, N={4 * N} x OUTCAP={scap}"] = (
        zo[0].reshape(4 * N, scap), ((zo[1].reshape(-1) + 7) // 8) * 8)
    add_slice("the zstd sequence sections", zo[4], ((zo[5] + 7) // 8) * 8)
    del zo
    kernel = phase_kernel(out, sizes, slices)
    del slices
    lap("phase 3")
    paths = {}
    paths["lz4"], c_lz4 = phase_main(data, blocks, arr, lens)
    lap("phase 4")
    phase_bench(data, blocks, arr, lens)
    lap("phase 5")
    paths["lz4hc"], c_hc, _ = phase_lz4hc(data, blocks, arr, lens)
    lap("phase 6")
    paths["lz4/lz4hc device decode"] = phase_decode(
        data, {"lz4": c_lz4, "lz4hc": c_hc}, dev)
    lap("phase 7")
    paths["snappy encode + device decode"] = phase_snappy(data, blocks, dev)
    lap("phase 8")
    (paths["zlib levels 1 and 2"], paths["zlib device inflate"],
     inflate, kraft) = phase_zlib(data, blocks, dev)
    lap("phase 9")
    (paths["zstd level 1 encode + device decode"], scans,
     entropy) = phase_zstd(data, blocks, dev)
    lap("phase 10")
    phase_bzip2_lzma(data, dev)
    lap("phase 11")
    surface, frame_err = phase_surface(data, dev)
    paths.update(surface)
    lap("phase 12")
    multi, scans_multi = phase_multi(data, blocks, dev)
    paths.update(multi)
    lap("phase 13")
    scans["fse_encode_scan"]["launches"] += scans_multi["fse_encode_scan"]
    # kraft_absorb's entry: its times at zlib 2's 288-symbol call, its
    # launches and error over every path and shape
    entropy["kraft_absorb"] = dict(
        kraft[288], max_abs_err=max(kraft[288]["max_abs_err"],
                                    kraft[32]["max_abs_err"],
                                    entropy["kraft_absorb"]["max_abs_err"]),
        launches=kraft[288]["launches"] + entropy["kraft_absorb"]["launches"]
        + scans_multi["kraft_absorb"])
    entropy["weights_fse_encode"]["launches"] += \
        scans_multi["weights_fse_encode"]
    kernel["max_abs_err"] = max(kernel["max_abs_err"], frame_err)
    print("[paths] compact_rows launches: " + ", ".join(
        f"{k} {v}" for k, v in paths.items()))

    kernels = [dict(name="compact_rows", route="cuda",
                    source="aocl_compression_tpu_torch/csrc/compact.cu",
                    replaces="aocl_compression_tpu/ops/compact.py:47",
                    launches=sum(paths.values()), bound_by="bytes",
                    **kernel)]
    replaces = {
        "fse_encode_scan": "aocl_compression_tpu/ops/zstd_device.py:491",
        "huf_literal_scan":
            "aocl_compression_tpu/ops/zstd_decode_device.py:114",
        "fse_sequence_scan":
            "aocl_compression_tpu/ops/zstd_decode_device.py:143"}
    for name, st in scans.items():
        kernels.append(dict(
            name=name, route="cuda",
            source="aocl_compression_tpu_torch/csrc/zstd_scan.cu",
            replaces=replaces[name], launches=st["launches"],
            max_abs_err=st["max_abs_err"], ms=st["ms"],
            plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
            bound_by="bytes", library_ms=None))
    kernels.append(dict(
        name="inflate_symbol_scan", route="cuda",
        source="aocl_compression_tpu_torch/csrc/inflate_scan.cu",
        replaces="aocl_compression_tpu/ops/inflate_device.py:121",
        launches=inflate["launches"], max_abs_err=inflate["max_abs_err"],
        ms=inflate["ms"], plain_ms=inflate["plain_ms"],
        bound_ms=inflate["bound_ms"], bound_by="bytes", library_ms=None))
    replaces = {
        "kraft_absorb": "aocl_compression_tpu/ops/deflate_device.py:229, "
                        "aocl_compression_tpu/ops/zstd_device.py:115",
        "weights_fse_encode": "aocl_compression_tpu/ops/zstd_device.py:166"}
    for name, st in entropy.items():
        kernels.append(dict(
            name=name, route="cuda",
            source="aocl_compression_tpu_torch/csrc/entropy_scan.cu",
            replaces=replaces[name], launches=st["launches"],
            max_abs_err=st["max_abs_err"], ms=st["ms"],
            plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
            bound_by="bytes", library_ms=None))
    replaces = {
        "subchain_reach": "aocl_compression_tpu/ops/lz4_device.py:516, :352",
        "chain_marks": "aocl_compression_tpu/ops/lz4_device.py:832, :849"}
    for name, st in CHAIN.items():
        if not PATH_LAUNCHES[name]:
            raise AssertionError(f"{name} was never launched on the paths")
        kernels.append(dict(
            name=name, route="cuda",
            source="aocl_compression_tpu_torch/csrc/chain_scan.cu",
            replaces=replaces[name], launches=PATH_LAUNCHES[name],
            max_abs_err=st["max_abs_err"], ms=st["ms"],
            plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
            bound_by="bytes", library_ms=None))
    for name in ("match_keys", "match_candidates", "match_runs"):
        if not PATH_LAUNCHES[name]:
            raise AssertionError(f"{name} was never launched on the paths")
        st = MATCH[name]
        kernels.append(dict(
            name=name, route="cuda",
            source="aocl_compression_tpu_torch/csrc/match_find.cu",
            replaces="aocl_compression_tpu/ops/lz4_device.py:138-243",
            launches=PATH_LAUNCHES[name], max_abs_err=st["max_abs_err"],
            ms=st["ms"], plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
            bound_by="bytes", library_ms=st.get("library_ms")))
    replaces = {
        "emit_lz4": "aocl_compression_tpu/ops/lz4_device.py:533-660",
        "emit_snappy": "aocl_compression_tpu/ops/snappy_device.py:192-320"}
    for name, where in replaces.items():
        if not PATH_LAUNCHES[name]:
            raise AssertionError(f"{name} was never launched on the paths")
        st = EMIT[name]
        kernels.append(dict(
            name=name, route="cuda",
            source="aocl_compression_tpu_torch/csrc/emit_sorted.cu",
            replaces=where, launches=PATH_LAUNCHES[name],
            max_abs_err=max(st["max_abs_err"], EMIT_SEEDED_ERR[name]),
            ms=st["ms"], plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
            bound_by="bytes", library_ms=None))
    print("[paths] chain, match and emit kernels' launches: "
          + json.dumps(PATH_LAUNCHES))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
