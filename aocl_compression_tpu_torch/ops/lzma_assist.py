"""Device match-finder assist for LZMA.

The port of aocl_compression_tpu/ops/lzma_assist.py. The LZMA range coder
is serial, but most of the encoder's time goes into match finding
(reference algos/lzma/LzFind.c hash chains). This tier moves that search
onto the device: the LZ4 pipeline's sort-based matcher and tile parse
(ops/lz4_device._find_matches at depth 16, _grid_parse at G = 1: one
sequence may start at every byte) elect non-overlapping (pos, len, dist)
sequences per 64 KiB block, one batch for all blocks, and the host
range-codes candidate-driven (csrc/lzma.cpp lzma_encode_cand: rep probes in
the gaps, no hash chains, every candidate revalidated, so a bad candidate
can only shorten a match). Matches cannot cross 64 KiB blocks and are
capped at the parse's match cap, so the ratio trails the host tier's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..runtime import native
from . import lz4_device as lz
from .compact import _no_mark

BLOCK = lz.MAX_DEVICE_BLOCK  # 64 KiB: the device matcher's offset domain


def _make_matcher(B: int, G: int, depth: int, match_cap: int):
    """The batched matcher: run(blocks (N, B) uint8, lens (N,) int32) ->
    the selected (pos, ml, off) (N, MAXSEQ) and nseq (N,) of each block,
    MAXSEQ = B // 4 + 2. mark(stage) is called after "find_matches" and
    "grid_parse"."""
    MAXSEQ = B // 4 + 2

    def run(blocks, lens, mark=_no_mark):
        mlen, moff, valid = lz._find_matches(blocks, lens, B, depth=depth)
        mark("find_matches")
        out = lz._grid_parse(mlen, moff, valid, B, G, MAXSEQ,
                             match_cap=match_cap)
        mark("grid_parse")
        return out

    return run


def elect_sequences(data: bytes, G: int = 4, depth: int = 8,
                    match_cap: int = 68, *, device,
                    mem_limit: Optional[int] = None,
                    mark=_no_mark) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """Run the matcher over data in 64 KiB blocks on `device`, one batch
    per group of <= mem_limit input bytes; returns the absolute-position
    (pos i64, len i32, dist i32) arrays, sorted. mark(stage) is called at
    "start", per batch after its upload ("h2d"), at the matcher's stages
    and after the fetch of its sequences ("d2h")."""
    mark("start")
    n = len(data)
    nb = (n + BLOCK - 1) // BLOCK
    flat = np.frombuffer(data, dtype=np.uint8)
    per = nb if not mem_limit else max(1, mem_limit // BLOCK)
    run = _make_matcher(BLOCK, G, depth, match_cap)
    cp, cl, cd = [], [], []
    for lo in range(0, nb, per):
        hi = min(nb, lo + per)
        arr = np.zeros((hi - lo, BLOCK), dtype=np.uint8)
        lens = np.zeros(hi - lo, dtype=np.int32)
        for i in range(lo, hi):
            blk = flat[i * BLOCK:(i + 1) * BLOCK]
            arr[i - lo, :len(blk)] = blk
            lens[i - lo] = len(blk)
        blocks_d = torch.from_numpy(arr).to(device)
        lens_d = torch.from_numpy(lens).to(device)
        mark("h2d")
        pos, ml, off, nseq = (t.cpu().numpy() for t in run(blocks_d, lens_d,
                                                           mark))
        mark("d2h")
        for i in range(hi - lo):
            k = int(nseq[i])
            if not k:
                continue
            cp.append(pos[i, :k].astype(np.int64) + (lo + i) * BLOCK)
            cl.append(ml[i, :k].astype(np.int32))
            cd.append(off[i, :k].astype(np.int32))
    if not cp:
        return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    return np.concatenate(cp), np.concatenate(cl), np.concatenate(cd)


def compress(data: bytes, level: int = 6, *, device,
             mem_limit: Optional[int] = None, mark=_no_mark) -> bytes:
    """Device-assisted LZMA encode: device match election at G = 1, depth
    16 (the JAX package's choice) and host candidate-driven range coding.
    The output is a standard FORMAT_ALONE stream. mark(stage) is called at
    elect_sequences' stages and after the host's "range_code"."""
    cp, cl, cd = elect_sequences(data, G=1, depth=16, device=device,
                                 mem_limit=mem_limit, mark=mark)
    out = native.lzma_compress_cand(data, level, cp, cl, cd)
    mark("range_code")
    return out
