"""LZ4 block encoder and decoder as batched tensor pipelines (tier TORCH).

The port of aocl_compression_tpu/ops/lz4_device.py: the sort-emit encoder
(G >= 2 tile-anchor parse), the exact-parse encoder (G = 0) and the
decoder. Every function takes a batch of blocks as (N, B) tensors on one
device — the batch dimension is written out where the JAX package vmaps a
per-block function — and returns exactly what the JAX function returns
for each block: the pipelines are integer-only and every sort key is
unique, so results are equal bit for bit.

Encode (per block, batched):
  1. hashing        — a u32 multiplicative hash of every position's 4-byte
                      window.
  2. match finding  — one sort of key (hash<<16 | pos) with the window words
                      gathered after it; the k-th previous entry with the
                      same hash is the k-th candidate, and its match length
                      comes from comparing the word chains. Offsets 1, 2 and
                      4 get exact run lengths by a reverse cummin, and the
                      saturated-match ladder extends matches past the cap
                      (on the card: the kernels match_keys, which gives
                      the sorted keys with no sort, match_candidates and
                      match_runs, comparing bytes with no word chains).
  3. parse          — one candidate per G-byte tile; the greedy tile chain is
                      marked by reachability inside sub-chains of SUBM
                      tiles (_reach_from_start: the kernel subchain_reach
                      on the card, matrix squarings on the CPU).
  4. emission       — every output byte is sourced from the input byte
                      domain; per-byte fields come from cummax/cummin fills
                      on the tile domain and one sort of (out_pos<<8 | byte)
                      materializes the stream (on the card: the kernel
                      emit_lz4, which writes each byte at its rank among
                      the row's output positions, with no sort).

Exact parse (G = 0, accel <= 1; the lz4hc device tier): the serial greedy
chain on the byte domain (_greedy_parse, marked by _chain_marks: the
kernel chain_marks on the card, matrix squarings on the CPU), the
selected sequences squeezed to MAXSEQ entries (_select_sequences), and the
fill + gather serializer (_emit) into rows of out_capacity(B) bytes.

Decode (per chunk, batched): _token_scan computes for every byte position
the token that would start there; _chain_marks marks the token chain from
0; monotone fills give each output byte its token's fields; the
back-references resolve by src = src[src] until no entry points into the
output (_resolve).

Word arithmetic: the window words are uint32 in the JAX package. Here they
are int32 holding the same 32-bit pattern (equality and byte masks agree);
the hash is computed in int64 with the multiplier split into 16-bit halves,
so no product overflows. Packed (hi << 16 | lo) fill values, which wrap as
int32 in the JAX package (`pack + _NEG`), are int64 here: the same numbers
without the wrap.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .compact import _no_mark

HASH_BITS = 15         # key packs (hash << 16) | pos into a positive int32
NW = 16                # extension words carried with each sorted entry
SMALL_OFFSETS = (1, 2, 4)  # offsets with exact (uncapped) run lengths
MIN_MATCH = 4
MFLIMIT = 12           # no match may start within the last 12 bytes
LAST_LITERALS = 5
_NEG = -(1 << 31)
_HASH_MUL = 2654435761
_DUMMY_POS = 1 << 17   # > any real out position (body <= B <= 64Ki)
_BIGPOS = 1 << 20
_I32 = torch.int32


def out_capacity(block_size: int) -> int:
    """Padded per-block output capacity (>= worst-case body size),
    rounded to the compaction row quantum (ops/compact.py)."""
    n = block_size + block_size // 255 + 64
    return -(-n // 512) * 512


def grid_for_accel(accel: int) -> int:
    """Map LZ4 acceleration to the parse mode: 0 = exact greedy chain,
    else the tile-anchor stride. accel 2 -> G=4, 3 -> 8, 4 -> 16, 5+ -> 32."""
    if accel <= 1:
        return 0
    return min(32, 1 << accel)


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=device)


def _shr(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """Shift right along the last axis by s (x[i - s]), filling the front."""
    return torch.cat([torch.full_like(x[:, :s], fill), x[:, :-s]], dim=1)


def _shl(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """Shift left along the last axis by s (x[i + s]), filling the back."""
    return torch.cat([x[:, s:], torch.full_like(x[:, :s], fill)], dim=1)


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(-1), dim=-1).values.flip(-1)


# =============================================================================
# Encoder
# =============================================================================

def _window_words(data_u8: torch.Tensor, B: int, nw: int = NW
                  ) -> List[torch.Tensor]:
    """w[k][:, i] = 4 bytes at position i + 4k, little-endian, as the int32
    holding the uint32's bit pattern."""
    N = data_u8.shape[0]
    d = data_u8.to(_I32)
    pad = torch.cat([d, d.new_zeros(N, 4 * nw + 8)], dim=1)

    def word_at(s):
        return (pad[:, s:s + B] | (pad[:, s + 1:s + B + 1] << 8)
                | (pad[:, s + 2:s + B + 2] << 16)
                | (pad[:, s + 3:s + B + 3] << 24))

    return [word_at(4 * k) for k in range(nw + 1)]


def _hash(w0: torch.Tensor, hash_bits: int) -> torch.Tensor:
    """(w0 * 2654435761 mod 2^32) >> (32 - hash_bits), as uint32 math."""
    w = w0.to(torch.int64) & 0xFFFFFFFF
    lo = w * (_HASH_MUL & 0xFFFF)
    hi = (w * (_HASH_MUL >> 16)) & 0xFFFF
    prod = (lo + (hi << 16)) & 0xFFFFFFFF
    return prod >> (32 - hash_bits)


def _chain_match_len(cur, prev, ok0, nw: int = NW):
    """Match length (>= MIN_MATCH where ok0) from two carried word chains."""
    mlen = torch.where(ok0, MIN_MATCH, 0).to(_I32)
    alive = ok0
    for k in range(1, nw + 1):
        x = cur[k] ^ prev[k]
        eqw = x == 0
        partial = (((x & 0xFF) == 0).to(_I32) + ((x & 0xFFFF) == 0).to(_I32)
                   + ((x & 0xFFFFFF) == 0).to(_I32))
        mlen = mlen + torch.where(alive, torch.where(eqw, 4, partial), 0)
        alive = alive & eqw
    return mlen


def _find_matches(data_u8: torch.Tensor, n: torch.Tensor, B: int,
                  max_off: int = 0, depth: int = 2, nw: int = NW,
                  small_offsets: tuple = SMALL_OFFSETS,
                  hash_bits: int = HASH_BITS, nw_deep: int = 0,
                  ext_passes: int = 0):
    """Per-position best (offset, matchlen) candidates for a batch.

    data_u8 (N, B) uint8, n (N,) int32 actual block lengths (the batch pads
    the last block). Returns (mlen, moff, valid), each (N, B), clamped to
    the format's end-of-block rules. max_off > 0 restricts candidates to a
    sliding window; depth = how many previous same-hash occurrences to
    consider; nw_deep > 0 trims the compare chains of the s >= 2 candidates
    to nw_deep words; ext_passes > 0 runs the saturated-match extension
    ladder. Same contract as the JAX package's _find_matches.

    A CUDA tensor runs the kernels match_keys (the sorted keys),
    match_candidates and match_runs (csrc/match_find.cu) and nothing else,
    a CPU tensor their plain versions (_find_matches_plain).
    """
    if data_u8.is_cuda:
        from . import match_find as mf
        stages = (mf.match_keys, mf.match_candidates, mf.match_runs)
        data_u8 = data_u8.contiguous()
        n = n.to(_I32).contiguous()
    elif data_u8.device.type == "cpu":
        stages = _MATCH_PLAIN
    else:
        raise ValueError(f"_find_matches: unsupported device {data_u8.device}")
    return _match_stages(stages, data_u8, n, B, max_off, depth, nw,
                         small_offsets, hash_bits, nw_deep, ext_passes)


def _find_matches_plain(data_u8: torch.Tensor, n: torch.Tensor, B: int,
                        max_off: int = 0, depth: int = 2, nw: int = NW,
                        small_offsets: tuple = SMALL_OFFSETS,
                        hash_bits: int = HASH_BITS, nw_deep: int = 0,
                        ext_passes: int = 0):
    """PyTorch version of _find_matches on any device: the three stages'
    plain versions."""
    return _match_stages(_MATCH_PLAIN, data_u8, n, B, max_off, depth, nw,
                         small_offsets, hash_bits, nw_deep, ext_passes)


def _match_stages(stages, data_u8, n, B, max_off, depth, nw, small_offsets,
                  hash_bits, nw_deep, ext_passes):
    """sorted keys -> candidates -> runs, with the (sorted keys,
    candidates, runs) functions given."""
    sorted_keys, candidates, runs = stages
    skey = sorted_keys(data_u8, B, hash_bits)
    best = candidates(data_u8, skey, B, max_off, depth, nw, nw_deep)
    return runs(data_u8, best, n, B, small_offsets, nw, ext_passes)


def _match_keys_plain(data_u8: torch.Tensor, B: int,
                      hash_bits: int) -> torch.Tensor:
    """The sort key of every position, (hash << 16 | pos) as the JAX
    package's int32 (the uint32 value wrapped): (N, B) int32."""
    idx = _arange(B, data_u8.device).expand(data_u8.shape[0], B)
    h = _hash(_window_words(data_u8, B, 0)[0], hash_bits)
    key = (h << 16) | idx.to(torch.int64)
    return torch.where(key >= (1 << 31), key - (1 << 32), key).to(_I32)


def _match_sorted_keys_plain(data_u8: torch.Tensor, B: int,
                             hash_bits: int) -> torch.Tensor:
    """Each row's sort keys in ascending order, (N, B) int32: the JAX
    package's sort of them, which groups a hash's positions in increasing
    order (the int32 wrap puts hashes >= 32,768 first at hash_bits 16).
    Plain version of the kernel match_keys."""
    return torch.sort(_match_keys_plain(data_u8, B, hash_bits),
                      dim=-1).values


def _match_candidates_plain(data_u8: torch.Tensor, skey: torch.Tensor,
                            B: int, max_off: int, depth: int, nw: int,
                            nw_deep: int) -> torch.Tensor:
    """Each position's best same-hash candidate from the rows' sorted keys:
    (N, B) int32 holding (offset << 16 | length), 1 << 16 where none. The
    k-th previous entry of the sorted row with the same hash is the k-th
    candidate; its match length comes from comparing the window-word
    chains carried through the sort. Plain version of the kernel
    match_candidates."""
    idx = _arange(B, data_u8.device).expand(data_u8.shape[0], B)
    words = _window_words(data_u8, B, nw)
    spos = skey & 0xFFFF
    perm = spos.to(torch.int64)   # the sort's permutation (B <= 2^16)
    swords = [torch.gather(w, 1, perm) for w in words]
    shash = (skey >> 16) & 0xFFFF   # logical shift of the 32-bit key

    best_len = torch.zeros_like(idx)
    best_off = torch.ones_like(idx)
    for s in range(1, depth + 1):  # k-th previous same-hash position
        nw_s = nw if (s == 1 or not nw_deep) else min(nw, nw_deep)
        ph = _shr(shash, s, -1)
        pp = _shr(spos, s, 0)
        pw = [_shr(w, s, -1) for w in swords[:nw_s + 1]]
        ok0 = (ph == shash) & (pw[0] == swords[0])
        # all s intermediate entries share the hash iff the s-th does
        # (sorted order groups hashes)
        off = spos - pp
        if max_off:
            ok0 = ok0 & (off <= max_off)
        ml = _chain_match_len(swords, pw, ok0, nw_s)
        better = ml > best_len
        best_len = torch.where(better, ml, best_len)
        best_off = torch.where(better, off, best_off)

    # restore position order: a scatter by the permutation is the JAX
    # package's second sort keyed by spos
    packed = (best_off.to(torch.int64) << 16) | best_len
    packed = torch.where(packed >= (1 << 31), packed - (1 << 32), packed)
    return torch.empty_like(best_len).scatter_(1, perm, packed.to(_I32))


def _match_runs_plain(data_u8: torch.Tensor, best: torch.Tensor,
                      n: torch.Tensor, B: int, small_offsets: tuple, nw: int,
                      ext_passes: int):
    """(mlen, moff, valid) from each position's best candidate (best as
    _match_candidates_plain returns it): exact runs at the small offsets,
    the saturated-match ladder, the end-of-block rules. Plain version of
    the kernel match_runs."""
    idx = _arange(B, data_u8.device).expand(data_u8.shape[0], B)
    best_len = best & 0xFFFF
    best_off = (best >> 16) & 0xFFFF

    # --- exact run lengths for small offsets (RLE / short periods) ---------
    d = data_u8.to(_I32)
    BIG = 2 * B
    rows = []
    for o in small_offsets:
        agree = torch.cat([torch.zeros_like(d[:, :o], dtype=torch.bool),
                           d[:, o:] == d[:, :-o]], dim=1) & (idx >= o)
        rows.append(torch.where(~agree, idx, BIG))
    nxt_all = _rev_cummin(torch.stack(rows, dim=1))
    for i, o in enumerate(small_offsets):
        run = torch.clamp(nxt_all[:, i], max=B) - idx
        better = (run >= MIN_MATCH) & (run > best_len)
        best_len = torch.where(better, run, best_len)
        best_off = torch.where(better, o, best_off)

    # --- saturated-match extension ladder -----------------------------------
    # A chain candidate caps at CAPV = MIN_MATCH + 4*nw verified bytes. If
    # position i is saturated and the candidate at i+CAPV carries the SAME
    # offset, the two verified spans concatenate — long matches resolve by
    # pointer doubling over the stride-CAPV functional graph.
    if ext_passes:
        CAPV = MIN_MATCH + 4 * nw
        link = (best_len >= CAPV) & (_shl(best_off, CAPV, 0) == best_off)
        elen = best_len
        stride = CAPV
        for _ in range(ext_passes):
            if stride >= B:
                break
            elen = torch.where(link, stride + _shl(elen, stride, 0), elen)
            link = link & _shl(link, stride, False)
            stride *= 2
        best_len = elen

    # --- end-of-block rules -------------------------------------------------
    nn = n.to(_I32)[:, None]
    best_len = torch.minimum(best_len, nn - LAST_LITERALS - idx)
    valid = (best_len >= MIN_MATCH) & (idx <= nn - MFLIMIT - 1) & (idx < nn)
    return (torch.where(valid, best_len, 1), torch.clamp(best_off, min=1),
            valid)


_MATCH_PLAIN = (_match_sorted_keys_plain, _match_candidates_plain,
                _match_runs_plain)


def _floor_chain_nxt(cpos, cml, cvalid, aidx, shift, M, G, match_cap=0):
    """Next-tile function of the greedy tile chain: jump to the tile
    containing the match end (t0) when that tile's elected anchor starts
    at or after the end, else t0+1.

    With a match cap, the floor test cpos[t0] >= end is evaluated by a
    K-deep shifted-select ladder over jumps bounded by cap//G + 2; longer
    jumps take t0+1. Without one it is a gather.
    """
    end = cpos + cml
    t0 = end >> shift
    K = (match_cap // G) + 2 if match_cap else 0
    if 0 < K <= 24:
        r = cpos - (aidx << shift)
        ein = end & (G - 1)
        jump = t0 - aidx
        ge = torch.zeros_like(cvalid)
        for j in range(1, K + 1):
            ge = ge | ((jump == j) & (_shl(r, j, 0) >= ein))
        use_floor = cvalid & (t0 > aidx) & (t0 < M) & ge
    else:
        t0c = torch.clamp(t0, 0, M - 1).to(torch.int64)
        use_floor = (cvalid & (t0 > aidx) & (t0 < M)
                     & (torch.gather(cpos, 1, t0c) >= end))
    return torch.where(cvalid, torch.where(use_floor, t0, t0 + 1), aidx + 1)


def _mat_dtype(device) -> torch.dtype:
    """Element type of the 0/1 reachability matrices: float16 on CUDA
    (integer bmm does not exist there), float32 on the CPU. Products are
    0/1 sums <= 128, exact in both."""
    return torch.float16 if torch.device(device).type == "cuda" else \
        torch.float32


def _closure(A: torch.Tensor, rounds: int) -> torch.Tensor:
    """The (S, K, K) 0/1 matrices A (of _mat_dtype) after `rounds`
    squarings, each clamped back to 0/1: entry (r, c) is 1 iff c is
    reachable from r in at most 2**rounds steps."""
    for _ in range(rounds):
        A = torch.bmm(A, A).clamp_(max=1)
    return A


def _reach_from_start(nxt: torch.Tensor, SUBM: int) -> torch.Tensor:
    """reach (N, M) bool for nxt (N, M) int32 on the tile domain, cut into
    sub-chains of SUBM tiles: tile t is reachable from its sub-chain's
    local 0 by the edges p -> nxt[p] that stay inside the sub-chain (0 <=
    nxt[p] - base < SUBM; exits and negative targets have none). It is
    row 0 of the JAX package's closure (lz4_device.py:352, :516). A CUDA
    tensor runs the kernel subchain_reach (csrc/chain_scan.cu), a CPU
    tensor the plain version."""
    if nxt.is_cuda:
        from . import chain_scan
        return chain_scan.subchain_reach(nxt.to(_I32).contiguous(), SUBM)
    if nxt.device.type == "cpu":
        return _reach_from_start_plain(nxt, SUBM)
    raise ValueError(f"_reach_from_start: unsupported device {nxt.device}")


def _reach_from_start_plain(nxt: torch.Tensor, SUBM: int) -> torch.Tensor:
    """PyTorch version of subchain_reach: (N*S, SUBM, SUBM) 0/1 adjacency
    matrices with the identity, ceil(log2(SUBM)) squarings, row 0."""
    N, M = nxt.shape
    dev = nxt.device
    S = M // SUBM
    aidx = _arange(M, dev)
    jloc = (nxt - (aidx // SUBM) * SUBM).reshape(N * S, SUBM)
    cols = _arange(SUBM, dev)
    edge = jloc[:, :, None] == cols[None, None, :]
    A = edge | torch.eye(SUBM, dtype=torch.bool, device=dev)[None]
    rounds = int(np.ceil(np.log2(max(SUBM, 2))))
    reach = _closure(A.to(_mat_dtype(dev)), rounds)[:, 0, :] > 0
    return reach.reshape(N, M)


def _grid_select(mlen, moff, valid, B: int, G: int, subm: int = 128,
                 match_cap: int = 0):
    """Tile-anchor election + chain marking, un-compacted: returns
    (sel, cpos, cml, coff), each (N, M) on the M = B//G tile domain.
    subm = chain-marking subblock width (matches clamp at subm*G byte
    boundaries)."""
    dev = mlen.device
    N = mlen.shape[0]
    M = B // G
    shift = int(np.log2(G))
    aidx = _arange(M, dev).expand(N, M)
    idx = _arange(B, dev).expand(N, B)

    # tile election: a shifted-max tournament on the byte domain;
    # score = net coverage (matchlen minus in-tile offset)
    score = torch.where(valid, mlen - (idx & (G - 1)), -1)
    sml, spos, soff = mlen, idx, moff
    for step in (1, 2, 4, 8, 16, 32)[:shift]:
        sc2 = _shl(score, step, -1)
        ml2 = torch.roll(sml, -step, dims=1)
        po2 = torch.roll(spos, -step, dims=1)
        of2 = torch.roll(soff, -step, dims=1)
        take = sc2 > score
        score = torch.maximum(score, sc2)
        sml = torch.where(take, ml2, sml)
        spos = torch.where(take, po2, spos)
        soff = torch.where(take, of2, soff)
    cvalid = score[:, ::G] >= 0
    cpos = spos[:, ::G]
    cml = sml[:, ::G]
    coff = soff[:, ::G]

    SUBM = min(M, subm)
    sub_end_pos = ((aidx // SUBM) + 1) * (SUBM * G)
    cml = torch.minimum(cml, sub_end_pos - cpos)
    cvalid = cvalid & (cml >= MIN_MATCH)

    nxt = _floor_chain_nxt(cpos, cml, cvalid, aidx, shift, M, G,
                           match_cap=match_cap)

    # independent SUBM-anchor sub-chains, each marked from its local 0
    # (exits have no edge)
    sel = _reach_from_start(nxt, SUBM) & cvalid
    return sel, cpos, cml, coff


def _greedy_parse(mlen, valid, B: int):
    """Exact serial-greedy selection: next[i] = i + (mlen if match else 1);
    chain-from-0 membership by _chain_marks, as the decoder marks token
    chains. Returns mark (N, B) bool."""
    N = mlen.shape[0]
    idx = _arange(B, mlen.device)
    nxt = torch.clamp(idx + torch.where(valid, mlen, 1), max=B)
    return _chain_marks(nxt, torch.full((N,), B, dtype=_I32,
                                        device=mlen.device), B)


def _grid_parse(mlen, moff, valid, B: int, G: int, MAXSEQ: int,
                match_cap: int = 0):
    """Tile-anchor parse (one sequence may start per G-byte tile),
    compacted: the selected (pos, ml, off, nseq) in MAXSEQ entries. The
    JAX package's _grid_parse repeats _grid_select's body at subm=128; here
    it is that call followed by the compaction."""
    sel, cpos, cml, coff = _grid_select(mlen, moff, valid, B, G, subm=128,
                                        match_cap=match_cap)
    M = B // G
    return _compact_selected(sel, _arange(M, mlen.device).expand_as(sel),
                             cpos, cml, coff, M, MAXSEQ)


def _compact_selected(sel, order, pos, ml, off, DOM: int, MAXSEQ: int):
    """Squeeze the selected sequences to the front, in `order`: the sort of
    the unique keys (order, or order + DOM when not selected) carrying the
    fields. More than MAXSEQ selected: the excess is dropped (its spans
    become literals of the following sequence, still format-exact).
    Returns (pos, ml, off) (N, MAXSEQ) and nseq (N,)."""
    N = sel.shape[0]
    dev = sel.device
    selkey = torch.where(sel, order, order + DOM)
    perm = torch.sort(selkey, dim=-1).indices
    nseq = torch.clamp(sel.sum(dim=1, dtype=_I32), max=MAXSEQ)
    real = _arange(MAXSEQ, dev) < nseq[:, None]
    k = min(DOM, MAXSEQ)

    def take(x, fill):
        x = torch.gather(x, 1, perm[:, :k])
        if MAXSEQ > DOM:
            x = torch.cat([x, x.new_full((N, MAXSEQ - DOM), fill)], dim=1)
        return torch.where(real, x, fill)

    return take(pos, 0), take(ml, 0), take(off, 1), nseq


def _select_sequences(mark, valid, mlen, moff, B: int, MAXSEQ: int):
    """Compact the exact parse's selected byte positions to MAXSEQ
    entries."""
    idx = _arange(B, mark.device).expand_as(mark)
    return _compact_selected(mark & valid, idx, idx, mlen, moff, B, MAXSEQ)


def _fill(values, starts, OUTCAP: int, init):
    """Segmented broadcast along the last axis: scatter-max `values` at
    `starts`, dropping slots >= OUTCAP (callers send unused entries to
    OUTCAP; starts are non-negative), then cummax-fill right. Valid iff
    `values` strictly increase over the kept entries. Returns (N, OUTCAP)
    of values' dtype."""
    N = values.shape[0]
    base = torch.full((N, OUTCAP + 1), init, dtype=values.dtype,
                      device=values.device)
    slot = torch.where((starts >= 0) & (starts < OUTCAP), starts, OUTCAP)
    base.scatter_reduce_(1, slot.to(torch.int64), values, reduce="amax")
    return torch.cummax(base[:, :OUTCAP], dim=1).values


def _emit(data_u8, pos, ml, off, nseq, n, B: int, OUTCAP: int, MAXSEQ: int):
    """Serialize the selected sequences into the LZ4 body (no final
    sequence). Returns (out (N, OUTCAP) uint8, body (N,), tail (N,)).
    Every output byte learns its sequence's fields from three monotone
    fills; the literal bytes are gathered from the input."""
    dev = pos.device
    i64 = torch.int64
    real = _arange(MAXSEQ, dev) < nseq[:, None]

    ends = pos + ml
    lit_start = torch.where(real, _shr(ends, 1, 0), 0)
    lit = torch.where(real, pos - lit_start, 0)

    # trailing literals after the last match (the stitcher's tail)
    last = torch.clamp(nseq - 1, 0, MAXSEQ - 1).to(i64)[:, None]
    has = nseq > 0
    tail = n.to(_I32) - torch.where(has, torch.gather(ends, 1, last)[:, 0],
                                    0)

    seq_sz = torch.where(real, 3 + _nlx_of(lit) + lit + _nmx_of(ml), 0)
    incl = torch.cumsum(seq_sz, dim=1, dtype=_I32)
    body = torch.where(has, torch.gather(incl, 1, last)[:, 0], 0)
    excl = incl - seq_sz

    # --- monotone fills: every output byte learns its sequence's fields ----
    starts = torch.where(real, excl, OUTCAP)
    f_excl = _fill(excl, starts, OUTCAP, 0)
    # pos < 2^16 strictly increases; lit_start likewise (ends are strict)
    f_po = _fill(((pos.to(i64) << 16) | off) + _NEG, starts, OUTCAP, _NEG)
    f_lm = _fill(((lit_start.to(i64) << 16) | ml) + _NEG, starts, OUTCAP,
                 _NEG)

    j = _arange(OUTCAP, dev)
    delta = j - f_excl
    po = f_po - _NEG
    lm = f_lm - _NEG
    pos_b = (po >> 16).to(_I32)
    off_b = (po & 0xFFFF).to(_I32)
    start_b = (lm >> 16).to(_I32)
    ml_b = (lm & 0xFFFF).to(_I32)
    lit_b = pos_b - start_b
    nlx_b = _nlx_of(lit_b)

    tok = (torch.clamp(lit_b, max=15) << 4) | torch.clamp(ml_b - MIN_MATCH,
                                                          max=15)
    lit_ext = torch.clamp(lit_b - 15 - 255 * (delta - 1), 0, 255)
    lit_byte_pos = torch.clamp(start_b + delta - 1 - nlx_b, 0, B - 1)
    lit_byte = torch.gather(data_u8, 1, lit_byte_pos.to(i64)).to(_I32)
    ml_ext = torch.clamp(ml_b - 19 - 255 * (delta - (3 + nlx_b + lit_b)),
                         0, 255)

    o_lo = 1 + nlx_b + lit_b
    byte = torch.where(
        delta == 0, tok,
        torch.where(delta <= nlx_b, lit_ext,
                    torch.where(delta < o_lo, lit_byte,
                                torch.where(delta == o_lo, off_b & 255,
                                            torch.where(delta == o_lo + 1,
                                                        off_b >> 8,
                                                        ml_ext)))))
    out = torch.where(j < body[:, None], byte, 0).to(torch.uint8)
    return out, body, tail


def _nlx_of(lit):
    return torch.where(lit < 15, 0, 1 + (lit - 15) // 255)


def _nmx_of(ml):
    return torch.where(ml - MIN_MATCH < 15, 0, 1 + (ml - 19) // 255)


def _emit_sorted(data_u8, n, sel, cpos, cml, coff, B: int, G: int):
    """Gather-free serializer: returns (out (N, B) uint8, body (N,),
    tail (N,), flag (N,)), as _emit_sorted_plain defines them.

    A CUDA tensor runs the kernel emit_lz4 (csrc/emit_sorted.cu: each
    output byte written at its rank among the row's output positions, no
    sort) and nothing else, a CPU tensor the plain version.
    """
    if data_u8.is_cuda:
        from . import emit_sorted as es
        return es.emit_lz4(data_u8.contiguous(), n.to(_I32).contiguous(),
                           sel, cpos, cml, coff, B, G)
    if data_u8.device.type == "cpu":
        return _emit_sorted_plain(data_u8, n, sel, cpos, cml, coff, B, G)
    raise ValueError(f"_emit_sorted: unsupported device {data_u8.device}")


def _emit_sorted_plain(data_u8, n, sel, cpos, cml, coff, B: int, G: int):
    """PyTorch version of _emit_sorted on any device: returns (out (N, B)
    uint8, body (N,), tail (N,), flag (N,)).

    Every output byte is sourced from the INPUT byte domain:
      - literal bytes carry their own input byte;
      - the >= MIN_MATCH matched positions of each sequence ("spares") carry
        its header bytes: spare k=0 -> token, 1..nlx -> literal-extension
        bytes, nlx+1/nlx+2 -> offset, nlx+3.. -> match-extension bytes.
    Per-byte covering-sequence fields come from monotone cummax/cummin
    fills on the tile domain, and ONE sort of (out_pos << 8 | byte)
    materializes the stream: coverage of [0, body) is exact by
    construction, so rank == position.

    A block is FLAGGED (host re-encode) iff some sequence's header needs
    more bytes than its match has spares (3 + nlx + nmx > ml) — only
    possible for a >=258-byte literal run followed by a tiny match.

    The packed fills hold uint32 packs as int64 values offset by _NEG,
    which is the JAX package's wrapping int32 `pack + _NEG`, without wrap.
    """
    dev = data_u8.device
    N = data_u8.shape[0]
    end_t = torch.where(sel, cpos + cml, 0)
    ce = torch.cummax(end_t, dim=1).values
    pe = _shr(ce, 1, 0)
    lit_t = torch.where(sel, cpos - pe, 0)
    ml_t = torch.where(sel, cml, 0)
    nlx_t = _nlx_of(lit_t)
    nmx_t = _nmx_of(ml_t)
    seq_sz = torch.where(sel, 3 + nlx_t + lit_t + nmx_t, 0)
    incl = torch.cumsum(seq_sz, dim=1, dtype=_I32)
    body = incl[:, -1]
    flag = torch.any(sel & (3 + nlx_t + nmx_t > ml_t), dim=1)
    tail = n.to(_I32) - ce[:, -1]

    # --- tile-domain monotone fills ----------------------------------------
    # F = fields of the last selected sequence at tile <= t; P = F's
    # predecessor; N = position of the next selected sequence at tile > t.
    # Packs are strictly increasing over selected tiles (pos/end increase),
    # so cummax-fill is a valid "last selected value" broadcast.
    i64 = torch.int64
    packF1 = ((cpos.to(i64) << 16) | coff) + _NEG            # pos_F, off_F
    packF2 = (((cpos + cml - 1).to(i64) << 16) | lit_t) + _NEG  # end_F-1, lit_F
    f1 = torch.cummax(torch.where(sel, packF1, _NEG), dim=1).values
    f2 = torch.cummax(torch.where(sel, packF2, _NEG), dim=1).values
    p1 = torch.cummax(torch.where(sel, _shr(f1, 1, _NEG), _NEG), dim=1).values
    p2 = torch.cummax(torch.where(sel, _shr(f2, 1, _NEG), _NEG), dim=1).values
    rn = _rev_cummin(torch.where(sel, cpos, _BIGPOS))
    rnx = _shl(rn, 1, _BIGPOS)  # next selected position at tile > t

    def unpack(f):
        u = f - _NEG
        return (u >> 16).to(_I32), (u & 0xFFFF).to(_I32)

    # unpack on the tile domain, then broadcast each tile's fields to its
    # G byte positions
    hasF = f1 != _NEG
    posF, offF = unpack(f1)
    endF1, litF = unpack(f2)
    endF = torch.where(hasF, endF1 + 1, 0)
    posP, offP = unpack(p1)
    endP1, litP = unpack(p2)

    def bcast(x):
        return torch.repeat_interleave(x, G, dim=1)

    hasF, posF, offF, endF, litF = map(bcast, (hasF, posF, offF, endF, litF))
    posP, offP, endP1, litP = map(bcast, (posP, offP, endP1, litP))
    b_incl, b_posN = bcast(incl), bcast(rnx)

    i = _arange(B, dev).expand(N, B)
    covered = hasF & (i < endF)
    useP = covered & (i < posF - litF)   # before F's literal run: P's spare

    pos_x = torch.where(useP, posP, posF)
    off_x = torch.where(useP, offP, offF)
    lit_x = torch.where(useP, litP, litF)
    end_x = torch.where(useP, endP1 + 1, endF)
    ml_x = end_x - pos_x
    nlx_x = _nlx_of(lit_x)
    nmx_x = _nmx_of(ml_x)
    sz_x = 3 + nlx_x + lit_x + nmx_x
    # exclusive output offset of the chosen sequence: incl[t] is the sum
    # through F; walk back one (F) or two (P) sequence sizes
    szF = 3 + _nlx_of(litF) + litF + _nmx_of(endF - posF)
    excl_x = torch.where(useP, b_incl - szF - sz_x, b_incl - sz_x)

    # --- N branch (literal of the next sequence / tail) --------------------
    litN = b_posN - endF
    nlxN = _nlx_of(litN)
    opN = b_incl + 1 + nlxN + (i - endF)

    # --- covered branch: role by spare index k -----------------------------
    k = i - pos_x
    is_lit = covered & (k < 0)
    # literal of X: out = excl + 1 + nlx + (i - lit_start)
    opL = excl_x + 1 + nlx_x + (i - (pos_x - lit_x))
    tok = (torch.clamp(lit_x, max=15) << 4) | torch.clamp(ml_x - MIN_MATCH,
                                                          max=15)
    j_lx = k - 1
    v_lx = torch.clamp(lit_x - 15 - 255 * j_lx, 0, 255)
    j_mx = k - nlx_x - 3
    v_mx = torch.clamp(ml_x - 19 - 255 * j_mx, 0, 255)
    base_lit_end = excl_x + 1 + nlx_x + lit_x   # offset field position
    op_sp = torch.where(
        k == 0, excl_x,
        torch.where(k <= nlx_x, excl_x + k,
                    torch.where(k == nlx_x + 1, base_lit_end,
                                torch.where(k == nlx_x + 2, base_lit_end + 1,
                                            base_lit_end + 2 + j_mx))))
    v_sp = torch.where(
        k == 0, tok,
        torch.where(k <= nlx_x, v_lx,
                    torch.where(k == nlx_x + 1, off_x & 255,
                                torch.where(k == nlx_x + 2, off_x >> 8,
                                            v_mx))))
    sp_dead = k >= 3 + nlx_x + nmx_x

    d = data_u8.to(_I32)
    op = torch.where(covered,
                     torch.where(is_lit, opL,
                                 torch.where(sp_dead, _DUMMY_POS, op_sp)),
                     torch.where(b_posN >= _BIGPOS, _DUMMY_POS, opN))
    val = torch.where(covered & ~is_lit, v_sp, d)
    op = torch.where(i < n.to(_I32)[:, None], op, _DUMMY_POS)

    key = torch.where(op >= _DUMMY_POS, 1 << 26, (op << 8) | val)
    skey = torch.sort(key, dim=-1).values
    out = torch.where(i < body[:, None], skey & 0xFF, 0).to(torch.uint8)
    return out, body, tail, flag


def _encode_block_v2(data_u8, n, B: int, G: int, depth: int = 2,
                     nw: int = NW, small_offsets: tuple = SMALL_OFFSETS,
                     subm: int = 128, lazy: int = 0,
                     hash_bits: int = HASH_BITS, nw_deep: int = 0,
                     ext_passes: int = 0, mark=_no_mark):
    """The sort-emit encoder. mark(stage) is called on the host after each
    stage is enqueued ("find_matches", "lazy", "grid_select",
    "emit_sorted"); chip_smoke.py records a CUDA event at each."""
    mlen, moff, valid = _find_matches(data_u8, n, B, depth=depth, nw=nw,
                                      small_offsets=small_offsets,
                                      hash_bits=hash_bits, nw_deep=nw_deep,
                                      ext_passes=ext_passes)
    mark("find_matches")
    for _ in range(lazy):
        valid = _lazy_demote(mlen, valid)
    mark("lazy")
    sel, cpos, cml, coff = _grid_select(mlen, moff, valid, B, G, subm=subm,
                                        match_cap=_match_cap(G, nw, subm,
                                                             ext_passes))
    mark("grid_select")
    res = _emit_sorted(data_u8, n, sel, cpos, cml, coff, B, G)
    mark("emit_sorted")
    return res


def _lazy_demote(mlen, valid):
    """One-step lazy demotion before tile election: drop a candidate when
    the next byte position holds a strictly-longer one."""
    nx_len = _shl(mlen, 1, 0)
    nx_val = _shl(valid, 1, False)
    return valid & ~(nx_val & (nx_len > mlen + 1))


def _match_cap(G: int, nw: int, subm: int, ext_passes: int) -> int:
    """Jump bound for the floor-chain ladder: extension can push matches
    past the hash cap up to the subblock clamp, and the ladder stays
    bounded (longer jumps take the t0+1 rule)."""
    return min(88, subm * G) if ext_passes else 4 + 4 * nw


def _encode_block(data_u8, n, B: int, OUTCAP: int, MAXSEQ: int, G: int = 0,
                  depth: int = 2, nw: int = NW, lazy: int = 0,
                  mark=_no_mark):
    """The fill + gather encoder: exact greedy parse (G=0) or the compacted
    tile parse (G >= 1), then _emit. Returns (out (N, OUTCAP), body,
    tail). mark(stage) is called on the host after each stage is enqueued
    ("find_matches", "lazy", then "greedy_parse" and "select_sequences" or
    "grid_parse", then "emit")."""
    mlen, moff, valid = _find_matches(data_u8, n, B, depth=depth, nw=nw)
    mark("find_matches")
    for _ in range(lazy):
        valid = _lazy_demote(mlen, valid)
    mark("lazy")
    if G:
        pos, ml, off, nseq = _grid_parse(mlen, moff, valid, B, G, MAXSEQ,
                                         match_cap=4 + 4 * nw)
        mark("grid_parse")
    else:
        marks = _greedy_parse(mlen, valid, B)
        mark("greedy_parse")
        pos, ml, off, nseq = _select_sequences(marks, valid, mlen, moff, B,
                                               MAXSEQ)
        mark("select_sequences")
    res = _emit(data_u8, pos, ml, off, nseq, n, B, OUTCAP, MAXSEQ)
    mark("emit")
    return res


def encoder_block_fn(B: int, G: int, depth: int = 2, nw: int = NW,
                     small_offsets: tuple = SMALL_OFFSETS, lazy: int = 0,
                     hash_bits: int = HASH_BITS, nw_deep: int = 0,
                     subm: int = 128, ext_passes: int = 0):
    """Batched encode fn + output row width, as the JAX package resolves
    them. G >= 2 runs the sort-emit path (depth 2 remapped to depth 4,
    nw 8) into rows of B bytes; G < 2 runs _encode_block into rows of
    out_capacity(B) bytes with no flags (small_offsets, hash_bits,
    nw_deep, subm and ext_passes apply to the sort-emit path only).
    Returns (fn(data_u8 (N, B), n (N,), mark=...) -> (out, body, tail,
    flag), out_width); mark is the stage hook of the encoder it runs."""
    if G >= 2:
        if depth == 2:
            depth, nw = 4, 8

        def fn(data_u8, n, mark=_no_mark):
            return _encode_block_v2(data_u8, n, B=B, G=G, depth=depth,
                                    nw=nw, small_offsets=small_offsets,
                                    subm=subm, lazy=lazy,
                                    hash_bits=hash_bits, nw_deep=nw_deep,
                                    ext_passes=ext_passes, mark=mark)

        return fn, B
    OUTCAP = out_capacity(B)
    MAXSEQ = (B // max(G, MIN_MATCH)) + 2

    def fn0(data_u8, n, mark=_no_mark):
        out, body, tail = _encode_block(data_u8, n, B=B, OUTCAP=OUTCAP,
                                        MAXSEQ=MAXSEQ, G=G, depth=depth,
                                        nw=nw, lazy=lazy, mark=mark)
        return out, body, tail, torch.zeros_like(body, dtype=torch.bool)

    return fn0, OUTCAP


def make_encoder(block_size: int, G: int = 0, depth: int = 2,
                 nw: int = NW, small_offsets: tuple = SMALL_OFFSETS,
                 lazy: int = 0, hash_bits: int = HASH_BITS,
                 nw_deep: int = 0, subm: int = 128, ext_passes: int = 0):
    """Build the batched encoder for a given block size / parse grid.

    Signature: (blocks uint8[N, B], lens int32[N]) ->
               (bodies uint8[N, W], body_sizes int32[N], tails int32[N],
                flags bool[N])
    on the device the inputs lie on; W is B for the sort-emit path (G >= 2)
    and out_capacity(B) for G < 2. flags marks blocks the sort-emit could
    not serialize (see _emit_sorted); the codec tier re-encodes those on
    the host. They are always False for G < 2.
    """
    fn, _ = encoder_block_fn(block_size, G, depth, nw, small_offsets, lazy,
                             hash_bits, nw_deep, subm, ext_passes)
    return fn


# =============================================================================
# Host-facing batch helpers (bytes in / bytes out)
# =============================================================================

def _bucket(n: int, lo: int = 256) -> int:
    """Round up to a power of two (the JAX package's jit buckets; kept so
    both packages encode the same padded batch)."""
    b = lo
    while b < n:
        b <<= 1
    return b


MAX_DEVICE_BLOCK = 65536  # positions/offsets are packed into 16 bits


def check_block_sizes(blocks, what: str = "encode"):
    """The device pipelines pack positions and LZ offsets into 16 bits, so
    any block beyond 64 KiB would silently corrupt."""
    big = max((len(b) for b in blocks), default=0)
    if big > MAX_DEVICE_BLOCK:
        raise ValueError(
            f"device {what}: block of {big} bytes exceeds the 64 KiB "
            f"device-pipeline limit (16-bit position packing); use the "
            f"host tier or block_size <= {MAX_DEVICE_BLOCK}")


def upload_blocks(blocks: Sequence[bytes], accel: int, device, mark,
                  bucket=None):
    """The padded batch every encoder takes: (blocks (N, B) uint8, lens
    (N,) int32) on `device`, the bucket B and the parse grid G of
    `accel` (0 for tiny blocks, where the grid's overhead isn't worth it).
    B is `bucket` where given (the multi-device tier passes the whole
    batch's to every shard, so all shards encode at one geometry), else
    the bucket of the longest block. mark(stage) is called at "start" and
    after the upload ("h2d")."""
    check_block_sizes(blocks)
    B = bucket or _bucket(max(len(b) for b in blocks))
    if max(len(b) for b in blocks) > B:
        raise ValueError(f"a block is longer than the bucket {B}")
    N = len(blocks)
    arr = np.zeros((N, B), dtype=np.uint8)
    lens = np.zeros(N, dtype=np.int32)
    for i, b in enumerate(blocks):
        arr[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i] = len(b)
    G = grid_for_accel(accel)
    if G and G * 4 > B:
        G = 0
    mark("start")
    arr_d = torch.from_numpy(arr).to(device)
    lens_d = torch.from_numpy(lens).to(device)
    mark("h2d")
    return arr_d, lens_d, B, G


def encode_blocks(blocks: Sequence[bytes], accel: int = 1, depth: int = 2,
                  nw: int = NW, lazy: int = 0, *, device, mark=_no_mark,
                  bucket=None):
    """Compress a list of blocks on `device`; returns (bodies, tails,
    flagged) where bodies exclude the final literal-only sequence
    (stitcher input). flagged lists the blocks the sort-emit encoder could
    not serialize (a giant literal run closed by a tiny match: the header
    exceeds the match's spare capacity); their bodies are None, and the
    codec tier re-encodes them on the host. mark(stage) is called on the
    host at "start", after the batch's upload is enqueued ("h2d"), and at
    the encoder's and the fetch's stage marks. bucket: upload_blocks'."""
    from . import compact
    arr_d, lens_d, B, G = upload_blocks(blocks, accel, device, mark, bucket)
    out, sizes, tails, flags = make_encoder(B, G, depth, nw, lazy=lazy)(
        arr_d, lens_d, mark=mark)
    bodies = compact.fetch_chunks(out, sizes, mark=mark)
    flagged = np.nonzero(flags.cpu().numpy())[0].tolist()
    for i in flagged:
        bodies[i] = None
    return bodies, tails.tolist(), flagged


# =============================================================================
# Decoder
# =============================================================================

SEG = 128  # chain-marking segment (one reachability matrix per segment)


def _token_scan(chunk_u8, clen, C: int):
    """For every byte position p of each chunk: if a token started at p,
    its (next token position, produced output bytes, literal length,
    literal start, offset), each (N, C). 255-extension runs come from a
    reverse next-non-255 scan."""
    N = chunk_u8.shape[0]
    dev = chunk_u8.device
    d = chunk_u8.to(_I32)
    pad = torch.cat([d, d.new_zeros(N, 8)], dim=1)
    idx = _arange(C, dev).expand(N, C)

    non255 = torch.where(d != 255, idx, 2 * C)
    nxt_non255 = torch.clamp(_rev_cummin(non255), max=C)

    def at(t, x):
        return torch.gather(t, 1, x.to(torch.int64))

    def ext_at(x):
        """(count of 255 bytes, terminating byte value) for a run at x."""
        cnt = torch.clamp(at(nxt_non255, torch.clamp(x, 0, C - 1)) - x, 0, C)
        return cnt, at(pad, torch.clamp(x + cnt, 0, C + 7))

    lit0 = d >> 4
    cnt_l, term_l = ext_at(idx + 1)
    lit = torch.where(lit0 < 15, lit0, 15 + 255 * cnt_l + term_l)
    a = idx + torch.where(lit0 < 15, 1, 2 + cnt_l)   # literal bytes start
    b = a + lit                                       # offset field
    is_final = b >= clen.to(_I32)[:, None]

    ml0 = d & 15
    cnt_m, term_m = ext_at(b + 2)
    ml = torch.where(ml0 < 15, ml0 + MIN_MATCH, 19 + 255 * cnt_m + term_m)
    nxt = torch.where(is_final, C,
                      torch.where(ml0 < 15, b + 2, b + 3 + cnt_m))
    nxt = torch.clamp(nxt, 0, C)
    produced = torch.where(is_final, lit, lit + ml)
    offs = (at(pad, torch.clamp(b, 0, C + 7))
            | (at(pad, torch.clamp(b + 1, 0, C + 7)) << 8))
    return nxt, produced, lit, a, offs


def _chain_marks(nxt, clen, C: int):
    """Mark the positions visited by the chain p -> nxt[p] from 0, for each
    row of nxt (N, C) int32 (C a multiple of SEG), as the JAX package's
    _chain_marks (lz4_device.py:806-859) does; positions >= clen are
    unmarked. A CUDA tensor runs the kernel chain_marks
    (csrc/chain_scan.cu), a CPU tensor the plain version."""
    if nxt.is_cuda:
        from . import chain_scan
        return chain_scan.chain_marks(nxt.to(_I32).contiguous(),
                                      clen.to(_I32).contiguous())
    if nxt.device.type == "cpu":
        return _chain_marks_plain(nxt, clen, C)
    raise ValueError(f"_chain_marks: unsupported device {nxt.device}")


def _chain_marks_plain(nxt, clen, C: int):
    """PyTorch version of chain_marks. Two levels, as in the JAX package:
    128-byte segments become (128, 128) reachability matrices (7
    squarings) of the in-segment edges; the largest column reachable from
    each entry, `last`, gives the segment's exit, nxt[segbase + last]. The
    JAX package threads the chain through the segments in order with a
    serial scan: an exit into the same or an earlier segment, or out of
    [0, C), ends the chain. Here the exit function F is composed by
    pointer doubling: with F^(2^j) tabled, the orbit start, F(start), ...
    doubles in length per round, until it holds S positions; it is cut at
    its first position whose segment is not past the one before. Each
    position left is its segment's entry, and the entry's matrix row is
    the segment's marks.
    """
    N = nxt.shape[0]
    dev = nxt.device
    i64 = torch.int64
    S = C // SEG
    idx = _arange(C, dev)
    segbase = (idx // SEG) * SEG
    jloc = nxt - segbase
    # the in-segment edge p -> nxt[p], else none (the identity's 1 at p)
    tgt = torch.where((jloc >= 0) & (jloc < SEG), jloc, idx - segbase)
    R = torch.zeros((N * S, SEG, SEG), dtype=_mat_dtype(dev), device=dev)
    R.scatter_(2, tgt.reshape(N * S, SEG, 1).to(i64), 1)
    R.diagonal(dim1=1, dim2=2).fill_(1)
    R = _closure(R, 7)

    # last in-segment reachable position per entry -> its nxt is the exit
    cols = torch.arange(SEG, dtype=R.dtype, device=dev)
    last = torch.amax(R * cols, dim=2).to(i64)          # (N*S, SEG)
    exit_ = torch.gather(nxt.reshape(N * S, SEG).to(i64), 1, last)
    exit_ = torch.where((exit_ >= 0) & (exit_ < C), exit_, C)

    # orbit of the start under F (F(C) = C ends a chain)
    F = torch.cat([exit_.reshape(N, C), torch.full((N, 1), C, dtype=i64,
                                                   device=dev)], dim=1)
    orbit = torch.where(clen > 0, 0, C).to(i64)[:, None]
    rounds = max(1, (S - 1).bit_length())   # 2**rounds >= S positions
    for r in range(rounds):
        orbit = torch.cat([orbit, torch.gather(F, 1, orbit)], dim=1)
        if r + 1 < rounds:
            F = torch.gather(F, 1, F)

    # the in-order scan's chain: the orbit while its segments rise; the
    # rest, and position C, land in column S
    seg = orbit // SEG
    rise = torch.cat([torch.ones_like(seg[:, :1]), (seg[:, 1:] > seg[:, :-1])
                      .to(i64)], dim=1)
    seg = torch.where(torch.cummin(rise, dim=1).values > 0, seg, S)
    entries = torch.full((N, S + 1), -1, dtype=i64, device=dev)
    entries.scatter_(1, seg, orbit % SEG)
    entries = entries[:, :S].reshape(N * S)
    rows = R[torch.arange(N * S, device=dev), torch.clamp(entries, 0)]
    mark = (rows > 0) & (entries >= 0)[:, None]
    return mark.reshape(N, C) & (idx < clen.to(_I32)[:, None])


def _decode_sources(chunk_u8, clen, dlen, C: int, B: int, mark=_no_mark):
    """Token scan, chain marks and the output map of each chunk."""
    nxt, produced, lit, a, offs = _token_scan(chunk_u8, clen, C)
    mark("token_scan")
    marks = _chain_marks(nxt, clen, C)
    mark("chain_marks")
    src = _output_map(marks, produced, lit, a, offs, dlen, B)
    mark("output_map")
    return src


def _output_map(mark, produced, lit, a, offs, dlen, B: int):
    """src (N, B) int32 from the marked tokens: src >= 0 is an earlier
    output byte (a back-reference), src < 0 is the chunk byte -src - 1 (a
    literal)."""
    N = mark.shape[0]
    dev = mark.device

    # --- output spans: monotone fills over the output domain ----------------
    prod_m = torch.where(mark, produced, 0)
    out_start = torch.cumsum(prod_m, dim=1, dtype=_I32) - prod_m
    emitting = mark & (produced > 0)
    tstart = torch.where(emitting, out_start, B)      # B slots drop

    f_ts = _fill(out_start, tstart, B, 0)             # token's output start
    # strictly monotone high bits: out_start of tokens emitting > 0 bytes
    f_off = _fill(((out_start.to(torch.int64) << 16) | (offs & 0xFFFF))
                  + _NEG, tstart, B, _NEG) - _NEG
    f_mstart = _fill(out_start + lit, tstart, B, 0)   # match part begins
    f_a = _fill(a, tstart, B, 0)                      # literal source base

    o = _arange(B, dev).expand(N, B)
    is_lit = o < f_mstart
    # offset 0 only occurs in corrupt streams; clamped to 1 so src always
    # points backwards and the resolve loop ends. An overlapping match
    # (off < ml) is a periodic fill: each byte is sourced from the first
    # period, (o - mstart) mod off (floor mod, as jnp.remainder).
    offv = torch.clamp(f_off & 0xFFFF, min=1).to(_I32)
    src = torch.where(is_lit, -(f_a + (o - f_ts)) - 1,
                      (f_mstart - offv) + torch.remainder(o - f_mstart, offv))
    return torch.where(o < dlen.to(_I32)[:, None], src, -1)


def _resolve(src, mark=_no_mark):
    """Follow back-references, src = src[src], until no entry is >= 0 (one
    host check per pass; mark("resolve_pass") after each). Returns (src,
    passes)."""
    B = src.shape[1]
    passes = 0
    while bool((src >= 0).any()):
        gathered = torch.gather(src, 1, torch.clamp(src, 0, B - 1).to(
            torch.int64))
        src = torch.where(src >= 0, gathered, src)
        passes += 1
        mark("resolve_pass")
    return src, passes


def _gather_output(chunk_u8, src, dlen):
    """Output bytes (N, B) uint8 from the resolved literal sources."""
    N, C = chunk_u8.shape
    B = src.shape[1]
    pad = torch.cat([chunk_u8, chunk_u8.new_zeros(N, 1)], dim=1)
    out = torch.gather(pad, 1, torch.clamp(-src - 1, 0, C).to(torch.int64))
    o = _arange(B, src.device)
    return torch.where(o < dlen.to(_I32)[:, None], out, 0)


def _decode_block(chunk_u8, clen, dlen, C: int, B: int, mark=_no_mark):
    """Decode a batch of chunks into (N, B) uint8. mark(stage) is called
    on the host after each stage is enqueued ("token_scan", "chain_marks",
    "output_map", "resolve_pass" per resolve pass, "resolve",
    "gather_output")."""
    src, _ = _resolve(_decode_sources(chunk_u8, clen, dlen, C, B, mark),
                      mark)
    mark("resolve")
    out = _gather_output(chunk_u8, src, dlen)
    mark("gather_output")
    return out


def make_decoder(chunk_cap: int, block_size: int):
    """Build the batched decoder.

    Signature: (chunks uint8[N, C], clens int32[N], dlens int32[N],
                mark=...) -> uint8[N, B]
    on the device the inputs lie on; mark is _decode_block's stage hook.
    """
    C, B = chunk_cap, block_size

    def decode(chunks, clens, dlens, mark=_no_mark):
        return _decode_block(chunks, clens, dlens, C=C, B=B, mark=mark)

    return decode


def decode_blocks(chunks: Sequence[bytes], dlens: Sequence[int],
                  block_size: int, *, device, mark=_no_mark,
                  bucket=None) -> List[bytes]:
    """Decompress a list of chunk regions on `device` (each decoding to
    <= 64 KiB). mark(stage) is called on the host, per device batch, at
    "start" (before the padded batch is built), after its upload is
    enqueued ("h2d_batch"), and at the decoder's and the fetch's stage
    marks. bucket: decode_batches'."""
    return decode_batches(make_decoder, chunks, dlens, block_size,
                          device=device, mark=mark, bucket=bucket)


def decode_batches(make_dec, chunks: Sequence[bytes], dlens: Sequence[int],
                   block_size: int, *, device, mark=_no_mark,
                   bucket=None) -> List[bytes]:
    """The host side of a device decoder (this module's, or the snappy
    decoder's): pad the chunks into (N, C) batches of at most
    (32 << 20) // C chunks, the JAX package's bound on the reachability
    matrices (S matrices of 128^2 per chunk), decode each with
    make_dec(C, B) and fetch the rows through the compaction. (C, B) is
    `bucket` where given (the multi-device tier passes the whole batch's
    to every shard), else the buckets of these chunks."""
    from . import compact
    if not chunks:
        return []
    if max(dlens) > MAX_DEVICE_BLOCK:
        raise ValueError(
            "device decode: decompressed block exceeds the 64 KiB limit "
            "(16-bit offset packing); use the host tier")
    C, B = bucket or (_bucket(max((len(c) for c in chunks), default=1)),
                      _bucket(max(max(dlens), block_size)))
    if max(len(c) for c in chunks) > C or max(dlens) > B:
        raise ValueError(f"a chunk does not fit the buckets ({C}, {B})")
    max_n = max(1, (32 << 20) // C)
    if len(chunks) > max_n:
        out = []
        for i in range(0, len(chunks), max_n):
            out.extend(decode_batches(make_dec, chunks[i:i + max_n],
                                      dlens[i:i + max_n], block_size,
                                      device=device, mark=mark,
                                      bucket=bucket))
        return out
    N = len(chunks)
    mark("start")
    arr = np.zeros((N, C), dtype=np.uint8)
    clens = np.zeros(N, dtype=np.int32)
    for i, c in enumerate(chunks):
        arr[i, :len(c)] = np.frombuffer(c, dtype=np.uint8)
        clens[i] = len(c)
    dl = torch.tensor(list(dlens), dtype=_I32, device=device)
    arr_d = torch.from_numpy(arr).to(device)
    clens_d = torch.from_numpy(clens).to(device)
    mark("h2d_batch")
    out = make_dec(C, B)(arr_d, clens_d, dl, mark=mark)
    if B % compact.ROWB == 0:
        return compact.fetch_chunks(out, dl, mark=mark)
    out_np = out.cpu().numpy()
    return [out_np[i, :dlens[i]].tobytes() for i in range(N)]
