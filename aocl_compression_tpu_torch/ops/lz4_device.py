"""LZ4 block encoder as a batched tensor pipeline (tier TORCH).

The port of aocl_compression_tpu/ops/lz4_device.py's sort-emit encoder
(G >= 2 tile-anchor parse). Every function takes a batch of blocks as
(N, B) tensors on one device — the batch dimension is written out where
the JAX package vmaps a per-block function — and returns exactly what the
JAX function returns for each block: the pipelines are integer-only and
every sort key is unique, so results are equal bit for bit.

Encode (per block, batched):
  1. hashing        — a u32 multiplicative hash of every position's 4-byte
                      window.
  2. match finding  — one sort of key (hash<<16 | pos) with the window words
                      gathered after it; the k-th previous entry with the
                      same hash is the k-th candidate, and its match length
                      comes from comparing the word chains. Offsets 1, 2 and
                      4 get exact run lengths by a reverse cummin, and the
                      saturated-match ladder extends matches past the cap.
  3. parse          — one candidate per G-byte tile; the greedy tile chain is
                      marked by boolean reachability, computed by batched
                      matrix squarings of 0/1 adjacency matrices.
  4. emission       — every output byte is sourced from the input byte
                      domain; per-byte fields come from cummax/cummin fills
                      on the tile domain and one sort of (out_pos<<8 | byte)
                      materializes the stream.

Word arithmetic: the window words are uint32 in the JAX package. Here they
are int32 holding the same 32-bit pattern (equality and byte masks agree);
the hash is computed in int64 with the multiplier split into 16-bit halves,
so no product overflows.

The exact G=0 parse and the device decoder are not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

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
    """
    dev = data_u8.device
    N = data_u8.shape[0]
    idx = _arange(B, dev).expand(N, B)
    words = _window_words(data_u8, B, nw)
    h = _hash(words[0], hash_bits)
    key = (h << 16) | idx.to(torch.int64)
    # the JAX key is the uint32 value cast to int32: sort in that order
    key = torch.where(key >= (1 << 31), key - (1 << 32), key).to(_I32)

    skey, perm = torch.sort(key, dim=-1)
    swords = [torch.gather(w, 1, perm) for w in words]
    spos = skey & 0xFFFF
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

    # restore position order: spos is the sort's permutation (B <= 2^16),
    # so a scatter by it is the JAX package's second sort keyed by spos
    best_len = torch.empty_like(best_len).scatter_(1, perm, best_len)
    best_off = torch.empty_like(best_off).scatter_(1, perm, best_off)

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


def _reach_from_start(A: torch.Tensor, rounds: int) -> torch.Tensor:
    """Row 0 of the boolean closure of the (S, SUBM, SUBM) 0/1 matrices A
    after `rounds` squarings. The products are 0/1 sums <= SUBM <= 128,
    exact in float32 (CPU) and float16 (CUDA, where integer bmm does not
    exist); each round clamps back to 0/1."""
    dt = torch.float16 if A.is_cuda else torch.float32
    A = A.to(dt)
    for _ in range(rounds):
        A = torch.clamp(torch.bmm(A, A), max=1)
    return A[:, 0, :] > 0


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
    S = M // SUBM
    sub_end_pos = ((aidx // SUBM) + 1) * (SUBM * G)
    cml = torch.minimum(cml, sub_end_pos - cpos)
    cvalid = cvalid & (cml >= MIN_MATCH)

    nxt = _floor_chain_nxt(cpos, cml, cvalid, aidx, shift, M, G,
                           match_cap=match_cap)

    # independent SUBM-anchor sub-chains: the chain-from-start marking is
    # boolean reachability by repeated squaring (exits have no edge)
    jloc = (nxt - (aidx // SUBM) * SUBM).reshape(N * S, SUBM)
    cols = _arange(SUBM, dev)
    edge = jloc[:, :, None] == cols[None, None, :]
    A = edge | torch.eye(SUBM, dtype=torch.bool, device=dev)[None]
    rounds = int(np.ceil(np.log2(max(SUBM, 2))))
    sel = _reach_from_start(A, rounds).reshape(N, M) & cvalid
    return sel, cpos, cml, coff


def _nlx_of(lit):
    return torch.where(lit < 15, 0, 1 + (lit - 15) // 255)


def _nmx_of(ml):
    return torch.where(ml - MIN_MATCH < 15, 0, 1 + (ml - 19) // 255)


def _emit_sorted(data_u8, n, sel, cpos, cml, coff, B: int, G: int):
    """Gather-free serializer: returns (out (N, B) uint8, body (N,),
    tail (N,), flag (N,)).

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
                     ext_passes: int = 0):
    mlen, moff, valid = _find_matches(data_u8, n, B, depth=depth, nw=nw,
                                      small_offsets=small_offsets,
                                      hash_bits=hash_bits, nw_deep=nw_deep,
                                      ext_passes=ext_passes)
    for _ in range(lazy):
        valid = _lazy_demote(mlen, valid)
    sel, cpos, cml, coff = _grid_select(mlen, moff, valid, B, G, subm=subm,
                                        match_cap=_match_cap(G, nw, subm,
                                                             ext_passes))
    return _emit_sorted(data_u8, n, sel, cpos, cml, coff, B, G)


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


def encoder_block_fn(B: int, G: int, depth: int = 2, nw: int = NW,
                     small_offsets: tuple = SMALL_OFFSETS, lazy: int = 0,
                     hash_bits: int = HASH_BITS, nw_deep: int = 0,
                     subm: int = 128, ext_passes: int = 0):
    """Batched encode fn + output row width, with the JAX package's
    default remap for the sort-emit path (G >= 2 with depth 2 runs depth 4,
    nw 8). Returns (fn(data_u8 (N, B), n (N,)) -> (out, body, tail, flag),
    out_width)."""
    if G < 2:
        raise NotImplementedError(
            "the exact G=0 parse is not ported yet; use accel >= 2")
    if depth == 2:
        depth, nw = 4, 8

    def fn(data_u8, n):
        return _encode_block_v2(data_u8, n, B=B, G=G, depth=depth, nw=nw,
                                small_offsets=small_offsets, subm=subm,
                                lazy=lazy, hash_bits=hash_bits,
                                nw_deep=nw_deep, ext_passes=ext_passes)

    return fn, B


def make_encoder(block_size: int, G: int = 0, depth: int = 2,
                 nw: int = NW, small_offsets: tuple = SMALL_OFFSETS,
                 lazy: int = 0, hash_bits: int = HASH_BITS,
                 nw_deep: int = 0, subm: int = 128, ext_passes: int = 0):
    """Build the batched encoder for a given block size / parse grid.

    Signature: (blocks uint8[N, B], lens int32[N]) ->
               (bodies uint8[N, B], body_sizes int32[N], tails int32[N],
                flags bool[N])
    on the device the inputs lie on. flags marks blocks the sort-emit
    could not serialize (see _emit_sorted); callers re-encode those on the
    host tier.
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


def encode_blocks(blocks: Sequence[bytes], accel: int = 1, depth: int = 2,
                  nw: int = NW, lazy: int = 0, *, device):
    """Compress a list of blocks on `device`; returns (bodies, tails) where
    bodies exclude the final literal-only sequence (stitcher input)."""
    from . import compact
    check_block_sizes(blocks)
    B = _bucket(max(len(b) for b in blocks))
    N = len(blocks)
    arr = np.zeros((N, B), dtype=np.uint8)
    lens = np.zeros(N, dtype=np.int32)
    for i, b in enumerate(blocks):
        arr[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i] = len(b)
    G = grid_for_accel(accel)
    if G and G * 4 > B:  # tiny blocks: grid overhead isn't worth it
        G = 0
    enc = make_encoder(B, G, depth, nw, lazy=lazy)
    out, sizes, tails, flags = enc(torch.from_numpy(arr).to(device),
                                   torch.from_numpy(lens).to(device))
    bodies = compact.fetch_chunks(out, sizes)
    tails = tails.tolist()
    flags = flags.cpu().numpy()
    if flags.any():
        # pathological blocks (giant literal run + tiny match: header
        # exceeds the match's spare capacity) — re-encode on the host
        # codec; same stitcher contract (body excludes the final
        # literal-only sequence)
        from ..codecs.lz4_stitch import final_sequence_len
        from ..runtime import native
        for i in np.nonzero(flags)[0]:
            stream, t = native.lz4_compress_tail(blocks[i], max(accel, 1))
            bodies[i] = stream[:len(stream) - final_sequence_len(t)]
            tails[i] = t
    return bodies, tails
