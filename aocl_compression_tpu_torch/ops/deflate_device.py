"""DEFLATE encoders as batched tensor pipelines (tier TORCH): static-Huffman
blocks (zlib level 1) and dynamic-Huffman blocks (zlib level 2).

The port of aocl_compression_tpu/ops/deflate_device.py. Per block:
  1. match finding — the LZ4 pipelines' matcher (ops/lz4_device.py) with
     offsets clamped to deflate's 32 KiB window;
  2. parse — the exact greedy parse (G = 0) or the compacted tile parse;
  3. piece split — matches become <= 258-byte (len, dist) pieces: the full
     pieces are 255 long so the remainder stays in [3, 258];
  4. bit budget — every input byte gets a bit width (a literal's code; a
     piece's first byte the piece's whole symbol width; other match bytes
     0); an exclusive cumsum gives each symbol's bit position;
  5. bit pack — the codes (bit-reversed, LSB-first) are scatter-added into
     the output bytes; Huffman bits never overlap, so add == or.
Each chunk ends with an empty stored block (a sync flush), so chunks are
byte-aligned and concatenate; the codec closes the stream with the empty
final static block 03 00.

The dynamic path also builds each block's length-limited, Kraft-exact
litlen and distance codes on the device (_kraft_lengths, whose Kraft
absorb is the hand kernel kraft_absorb of csrc/entropy_scan.cu on CUDA and
its plain loop on the CPU; _canonical_codes) and emits the body at bit
offset 0; the host writes
the block header (HLIT/HDIST/HCLEN and the RLE'd code lengths) from the
fetched code lengths and shifts the body in behind it (_splice_dyn).

Every function takes a batch as (N, ...) tensors on one device and returns
what the JAX function returns for each block, bit for bit. Scatters with
the JAX package's mode="drop" write into a buffer with one spare slot that
is cut off; an entry that is dropped adds 0 to a slot of its own row, so
the dropped entries do not pile atomics onto the spare slot.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import lz4_device as lz
from .compact import _no_mark
from .lz4_device import _I32, MIN_MATCH, _arange

MAX_DIST = 32768
MAX_MATCH = 258
SYNC_FLUSH = b"\x00\x00\xff\xff"          # empty stored block after 3+pad bits
FINAL_BLOCK = b"\x03\x00"                 # BFINAL=1 BTYPE=01 + EOB
ZLIB_HEADER = b"\x78\x01"                 # CMF/FLG, level-1 class


def out_capacity(block_size: int) -> int:
    # worst case: all 9-bit literals + headers + flush slack; row-aligned
    n = block_size + block_size // 8 + 64
    return -(-n // 512) * 512


def _scatter_add(buf: torch.Tensor, idx: torch.Tensor, val,
                 keep: Optional[torch.Tensor] = None) -> None:
    """buf (N, cap + 1) += val at idx along the last axis, in place, with
    the JAX package's mode="drop": entries outside [0, cap) (or not
    `keep`) are dropped. A dropped entry adds 0 at its own column modulo
    cap instead of landing on the spare slot."""
    cap = buf.shape[1] - 1
    ok = (idx >= 0) & (idx < cap)
    if keep is not None:
        ok = ok & keep
    spread = _arange(idx.shape[1], idx.device) % cap
    val = torch.as_tensor(val, dtype=buf.dtype, device=buf.device)
    buf.scatter_add_(1, torch.where(ok, idx, spread).to(torch.int64),
                     torch.where(ok, val, 0).to(buf.dtype).expand_as(idx))


def _pow2(e: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(e) << e


def _floor_log2(m, top: int):
    """floor(log2(m)) for 1 <= m < 2**top, exact (integer compares)."""
    e = torch.zeros_like(m)
    for k in range(1, top):
        e = e + (m >= (1 << k)).to(m.dtype)
    return e


def _rev_bits(v, n, width: int = 9):
    """Reverse the n low bits of v (n a tensor or an int, n <= width)."""
    n = torch.as_tensor(n, dtype=v.dtype, device=v.device)
    r = torch.zeros_like(v)
    for k in range(width):
        bit = (v >> k) & 1
        sh = torch.clamp(n - 1 - k, 0, width)
        r = r | torch.where(k < n, bit << sh, 0)
    return r


def _lit_code(b):
    """Static litlen code for a literal byte: (reversed code, nbits)."""
    nb = torch.where(b < 144, 8, 9).to(b.dtype)
    val = torch.where(b < 144, 0x30 + b, 0x190 + (b - 144))
    return _rev_bits(val, nb), nb


def _len_code_idx(l):
    """Length l in [3,258] -> litlen symbol index 257..285 + extra."""
    m = l - 3
    e = _floor_log2(torch.clamp(m, min=1), 8)
    eb = torch.where(m < 8, 0, torch.clamp(e - 2, min=0))
    codei = torch.where(m < 8, 257 + m, 257 + 4 * eb + (m >> eb))
    codei = torch.where(m == 255, 285, codei)
    eb = torch.where(m == 255, 0, eb)
    extra = m & (_pow2(eb) - 1)
    return codei, extra, eb


def _dist_code_idx(d):
    """Distance d in [1,32768] -> dist symbol index 0..29 + extra."""
    m = d - 1
    e = _floor_log2(torch.clamp(m, min=1), 15)
    codei = torch.where(m < 4, m, 2 * e + (m >> torch.clamp(e - 1, min=0))
                        - 2)
    eb = torch.where(m < 4, 0, torch.clamp(e - 1, min=0))
    extra = m & (_pow2(eb) - 1)
    return codei, extra, eb


def _len_sym(l):
    """Length l in [3,258] -> (reversed static code bits, code nbits,
    extra value, extra nbits)."""
    code, extra, eb = _len_code_idx(l)
    cb = torch.where(code <= 279, 7, 8).to(l.dtype)
    val = torch.where(code <= 279, code - 256, 0xC0 + (code - 280))
    return _rev_bits(val, cb), cb, extra, eb


def _dist_sym(d):
    """Distance d in [1,32768] -> (reversed 5-bit code, extra, extra bits)."""
    code, extra, eb = _dist_code_idx(d)
    return _rev_bits(code, 5, 5), extra, eb


def _pieces(data_u8, pos, ml, off, nseq, n, B: int, MAXSEQ: int,
            MAXPIECE: int):
    """The piece split and the literal mask shared by both emitters:
    (preal, p_len, p_dist, p_byte) on the (N, MAXPIECE) piece domain and
    is_lit (N, B)."""
    dev = pos.device
    N = pos.shape[0]
    sid = _arange(MAXSEQ, dev).expand(N, MAXSEQ)
    real = sid < nseq[:, None]
    ml = torch.where(real, ml, 0)
    ends = pos + ml

    # all full pieces 255 long, the remainder in [3, 258]
    nfull = torch.where(real, torch.clamp(ml - 4, min=0) // 255, 0)
    lastlen = ml - 255 * nfull
    npiece = torch.where(real, nfull + 1, 0)
    incl = torch.cumsum(npiece, dim=1, dtype=_I32)
    p_excl = incl - npiece
    ntot = incl[:, -1]

    # piece -> owning sequence via a monotone fill on the piece domain
    pid = _arange(MAXPIECE, dev)
    preal = pid < ntot[:, None]
    pstarts = torch.where(real & (npiece > 0), p_excl, MAXPIECE)
    ps = lz._fill(sid, pstarts, MAXPIECE, 0).to(torch.int64)

    def at(x):
        return torch.gather(x, 1, ps)

    j_in = pid - at(p_excl)
    p_len = torch.where(j_in < at(nfull), 255, at(lastlen))
    p_len = torch.where(preal, torch.clamp(p_len, 3, MAX_MATCH), 3)
    p_dist = torch.clamp(at(off), 1, MAX_DIST)
    p_byte = torch.where(preal, at(pos) + 255 * j_in, 0)

    # literal mask: +1 at each match start, -1 at its end, cumsum
    cov = torch.zeros((N, B + 1), dtype=_I32, device=dev)
    _scatter_add(cov, torch.where(real, pos, B), 1)
    _scatter_add(cov, torch.where(real, ends, B), -1)
    cover = torch.cumsum(cov[:, :B], dim=1)
    is_lit = (cover == 0) & (_arange(B, dev) < n.to(_I32)[:, None])
    return preal, p_len.to(_I32), p_dist.to(_I32), p_byte.to(_I32), is_lit


def _emit_deflate(data_u8, pos, ml, off, nseq, n, B: int, OUTCAP: int,
                  MAXSEQ: int, MAXPIECE: int):
    """Serialize the sequences and the literals into one static block per
    row: header, symbols, EOB and the empty stored block (its FFFF written
    in place). Returns (out (N, OUTCAP) uint8, chunk sizes (N,))."""
    dev = pos.device
    N = pos.shape[0]
    preal, p_len, p_dist, p_byte, is_lit = _pieces(
        data_u8, pos, ml, off, nseq, n, B, MAXSEQ, MAXPIECE)
    d32 = data_u8.to(_I32)

    lrev, lcb, lex, leb = _len_sym(p_len)
    drev, dex, deb = _dist_sym(p_dist)
    p_bits = lcb + leb + 5 + deb
    p_val_lo = lrev | (lex << lcb)                       # <= 13 bits
    p_val_hi = drev | (dex << 5)                         # <= 18 bits
    p_shift_hi = lcb + leb                               # where hi part goes

    # per-byte bit widths -> bit positions (3 header bits first)
    lit_rev, lit_nb = _lit_code(d32)
    w = torch.zeros((N, B + 1), dtype=_I32, device=dev)
    w[:, :B] = torch.where(is_lit, lit_nb, 0)
    _scatter_add(w, p_byte, p_bits, preal)
    w = w[:, :B]
    cw = torch.cumsum(w, dim=1, dtype=_I32)
    bitpos = 3 + cw - w
    total_bits = 3 + cw[:, B - 1] + 7                    # header + EOB

    # scatter-add the bit stream into bytes
    out = torch.zeros((N, OUTCAP + 1), dtype=_I32, device=dev)
    out[:, 0] = 2                                        # BTYPE=01 header
    lb = bitpos >> 3
    lv = lit_rev << (bitpos & 7)                         # <= 16 bits
    for k in range(2):
        _scatter_add(out, lb + k, (lv >> (8 * k)) & 0xFF, is_lit)

    pbit = torch.gather(bitpos, 1, torch.clamp(p_byte, 0, B - 1).to(
        torch.int64))
    pb = pbit >> 3
    vlo = p_val_lo << (pbit & 7)                         # <= 20 bits
    for k in range(3):
        _scatter_add(out, pb + k, (vlo >> (8 * k)) & 0xFF, preal)
    hi_bit = pbit + p_shift_hi
    hb = hi_bit >> 3
    vhi = p_val_hi << (hi_bit & 7)                       # <= 25 bits
    for k in range(4):
        _scatter_add(out, hb + k, (vhi >> (8 * k)) & 0xFF, preal)

    # stored-block sync flush: 3 zero bits + pad (already zero) + LEN/NLEN
    # (LEN=0x0000 is already zero; write NLEN=0xFFFF in place)
    data_end = (total_bits + 3 + 7) >> 3
    ff_idx = torch.stack([data_end + 2, data_end + 3], dim=1)
    out.scatter_add_(1, torch.clamp(ff_idx, max=OUTCAP - 1).to(torch.int64),
                     torch.full_like(ff_idx, 0xFF))
    return out[:, :OUTCAP].to(torch.uint8), data_end + 4


# =============================================================================
# Dynamic-Huffman blocks (BTYPE=10)
# =============================================================================

_NLIT, _NDIST, _MAXLEN = 288, 32, 15


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """The int32 value an int64 product wraps to in the JAX package."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _kraft_lengths(hist, NSYM: int, MAXLEN: int = _MAXLEN):
    """Length-limited, Kraft-exact code lengths for each row of hist
    (N, NSYM): (nb (N, NSYM) int32, ok (N,) bool).

    The JAX package's lax.sort by (-hist, sym) is one sort of the unique
    key -hist * 1024 + sym; its lax.scan over the sorted symbols is
    _kraft_absorb."""
    i64 = torch.int64
    present = hist > 0
    total = torch.clamp(hist.sum(dim=1, dtype=i64), min=1)[:, None]
    share = torch.div(_wrap32(hist.to(i64) * (1 << MAXLEN)), total,
                      rounding_mode="floor").to(_I32)
    f = _floor_log2(torch.clamp(share, min=1), MAXLEN + 1)
    nb = torch.where(present, torch.clamp(MAXLEN - f, 1, MAXLEN), 0)
    contrib = torch.where(present, _pow2(MAXLEN - torch.clamp(nb, min=1)), 0)
    D = (1 << MAXLEN) - contrib.sum(dim=1, dtype=_I32)

    sym = _arange(NSYM, hist.device)
    order = torch.sort(-hist.to(i64) * 1024 + sym, dim=1).indices
    nbs2, D = _kraft_absorb(torch.gather(nb, 1, order), D, MAXLEN)
    nb_final = torch.empty_like(nbs2).scatter_(1, order, nbs2)
    ok = (D == 0) & (present.sum(dim=1) >= 2)
    return nb_final, ok


def _kraft_absorb(nbs, D, MAXLEN: int):
    """The Kraft deficit D (N,) absorbed over each row's sorted code
    lengths nbs (N, NSYM), int32 in [0, MAXLEN]: (nbs2, D left), the JAX
    package's lax.scan (deflate_device._kraft_lengths, zstd_device.
    _block_huffman). A CUDA tensor runs the kernel kraft_absorb
    (csrc/entropy_scan.cu), a CPU tensor the plain loop."""
    if nbs.is_cuda:
        from . import entropy_scan
        return entropy_scan.kraft_absorb(nbs, D, MAXLEN)
    if nbs.device.type == "cpu":
        return _kraft_absorb_plain(nbs, D, MAXLEN)
    raise ValueError(f"_kraft_absorb: unsupported device {nbs.device}")


def _kraft_absorb_plain(nbs, D, MAXLEN: int):
    """PyTorch version of kraft_absorb: one step of tensor ops per symbol
    over all N rows. A code length c = 2^sh, so the scan's D // c is
    D >> sh."""
    sh_s = MAXLEN - torch.clamp(nbs, min=1)
    c_s = torch.where(nbs > 0, _pow2(sh_s), 0)
    lim_s = torch.clamp(nbs - 1, min=0)
    ks = []
    for s in range(nbs.shape[1]):
        c = c_s[:, s]
        q = torch.clamp(torch.where(c > 0, (D >> sh_s[:, s]) + 1, 1), min=1)
        # floor(log2 q) of q in [1, 2^16]: frexp is exact on these floats
        k = torch.minimum(torch.frexp(q.to(torch.float32)).exponent - 1,
                          lim_s[:, s])
        D = D - c * (_pow2(k) - 1)
        ks.append(k)
    return nbs - torch.stack(ks, dim=1).to(nbs.dtype), D


def _canonical_codes(nb, NSYM: int, MAXLEN: int = _MAXLEN):
    """RFC 1951 canonical code assignment from the code lengths of each
    row (N, NSYM), returned bit-reversed for LSB-first emission."""
    N = nb.shape[0]
    dev = nb.device
    bl = torch.zeros((N, MAXLEN + 1), dtype=_I32, device=dev)
    bl.scatter_add_(1, torch.clamp(nb, 0, MAXLEN).to(torch.int64),
                    (nb > 0).to(_I32))
    c = torch.zeros(N, dtype=_I32, device=dev)
    ncs = [c]
    for l in range(1, MAXLEN + 1):
        c = (c + bl[:, l - 1] * (l > 1)) << 1
        ncs.append(c)
    nc = torch.stack(ncs, dim=1)
    rank = torch.zeros_like(nb)
    for l in range(1, MAXLEN + 1):
        m = (nb == l).to(_I32)
        rank = rank + torch.where(nb == l, torch.cumsum(m, dim=1) - m, 0)
    code = torch.gather(nc, 1, torch.clamp(nb, 0, MAXLEN).to(torch.int64)) \
        + rank
    return _rev_bits(code, nb, MAXLEN)


def _emit_deflate_dyn(data_u8, pos, ml, off, nseq, n, B: int, OUTCAP: int,
                      MAXSEQ: int, MAXPIECE: int, mark=_no_mark):
    """Dynamic-block bodies at bit offset 0 and their code lengths.

    Returns (out (N, OUTCAP) uint8, body_bits (N,), nb_lit (N, 288),
    nb_dist (N, 32), ok (N,)). The host writes each header and splices; a
    block whose Kraft fixup fails (ok False) is re-encoded statically.
    mark(stage) is called after "histograms", "kraft_lengths",
    "canonical_codes" and "emit" are enqueued."""
    dev = pos.device
    N = pos.shape[0]
    preal, p_len, p_dist, p_byte, is_lit = _pieces(
        data_u8, pos, ml, off, nseq, n, B, MAXSEQ, MAXPIECE)
    d32 = data_u8.to(_I32)
    lci, lex, leb = _len_code_idx(p_len)
    dci, dex, deb = _dist_code_idx(p_dist)

    # --- histograms ---------------------------------------------------------
    hist_lit = torch.zeros((N, _NLIT + 1), dtype=_I32, device=dev)
    _scatter_add(hist_lit, d32, 1, is_lit)
    _scatter_add(hist_lit, lci, 1, preal)
    hist_lit[:, 256] += 1                                  # EOB
    hist_dist = torch.zeros((N, _NDIST + 1), dtype=_I32, device=dev)
    _scatter_add(hist_dist, dci, 1, preal)
    # a complete dist code needs >= 2 symbols; force 0/1 present (costs
    # only header bits — zlib does the same for degenerate blocks)
    hist_dist[:, :2] = torch.clamp(hist_dist[:, :2], min=1)
    hist_lit, hist_dist = hist_lit[:, :_NLIT], hist_dist[:, :_NDIST]
    mark("histograms")

    nb_lit, ok1 = _kraft_lengths(hist_lit, _NLIT)
    nb_dist, ok2 = _kraft_lengths(hist_dist, _NDIST)
    mark("kraft_lengths")
    code_lit = _canonical_codes(nb_lit, _NLIT)
    code_dist = _canonical_codes(nb_dist, _NDIST)
    ok = ok1 & ok2
    mark("canonical_codes")

    # --- per-byte bit widths -> bit offsets (body starts at bit 0) ----------
    def at(table, i):
        return torch.gather(table, 1, i.to(torch.int64))

    lit_nb = at(nb_lit, torch.clamp(d32, 0, 255))
    lit_rev = at(code_lit, torch.clamp(d32, 0, 255))
    li = torch.clamp(lci, 0, _NLIT - 1)
    p_lnb, p_lrev = at(nb_lit, li), at(code_lit, li)
    p_dnb, p_drev = at(nb_dist, dci), at(code_dist, dci)
    p_bits = p_lnb + leb + p_dnb + deb
    w = torch.zeros((N, B + 1), dtype=_I32, device=dev)
    w[:, :B] = torch.where(is_lit, lit_nb, 0)
    _scatter_add(w, p_byte, p_bits, preal)
    w = w[:, :B]
    cw = torch.cumsum(w, dim=1, dtype=_I32)
    bitpos = cw - w
    body_bits = cw[:, B - 1] + nb_lit[:, 256]              # + EOB

    # --- scatter-add the bit stream -----------------------------------------
    out = torch.zeros((N, OUTCAP + 1), dtype=_I32, device=dev)
    lb = bitpos >> 3
    lv = lit_rev << (bitpos & 7)                           # <= 15+7 bits
    for k in range(3):
        _scatter_add(out, lb + k, (lv >> (8 * k)) & 0xFF, is_lit)

    pbit = torch.gather(bitpos, 1, torch.clamp(p_byte, 0, B - 1).to(
        torch.int64))
    # length code + extra (<= 15 + 5 = 20 bits), then dist code + extra
    vlo = p_lrev | (lex << p_lnb)
    vhi = p_drev | (dex << p_dnb)
    pb = pbit >> 3
    vlo_s = vlo << (pbit & 7)                              # <= 27 bits
    for k in range(4):
        _scatter_add(out, pb + k, (vlo_s >> (8 * k)) & 0xFF, preal)
    hi_bit = pbit + p_lnb + leb
    # vhi is up to 28 bits: emit it in two 16-bit halves, each shifted
    # locally, as the JAX package does to stay inside int32
    h0 = vhi & 0xFFFF
    h1 = vhi >> 16                                         # <= 12 bits
    v0 = h0 << (hi_bit & 7)                                # <= 23 bits
    for k in range(3):
        _scatter_add(out, (hi_bit >> 3) + k, (v0 >> (8 * k)) & 0xFF, preal)
    v1 = h1 << ((hi_bit + 16) & 7)                         # <= 19 bits
    for k in range(3):
        _scatter_add(out, ((hi_bit + 16) >> 3) + k, (v1 >> (8 * k)) & 0xFF,
                     preal)

    # EOB at the end of the body
    ebit = (body_bits - nb_lit[:, 256])[:, None]
    ev = code_lit[:, 256:257] << (ebit & 7)
    for k in range(3):
        _scatter_add(out, (ebit >> 3) + k, (ev >> (8 * k)) & 0xFF)
    mark("emit")
    return out[:, :OUTCAP].to(torch.uint8), body_bits, nb_lit, nb_dist, ok


def _parse(data_u8, n, B: int, MAXSEQ: int, G: int, mark):
    """Matches in the 32 KiB window and the parse shared by both encoders:
    (pos, ml, off, nseq) in MAXSEQ entries."""
    mlen, moff, valid = lz._find_matches(data_u8, n, B, max_off=MAX_DIST)
    mark("find_matches")
    if G:
        res = lz._grid_parse(mlen, moff, valid, B, G, MAXSEQ, match_cap=68)
        mark("grid_parse")
        return res
    marks = lz._greedy_parse(mlen, valid, B)
    mark("greedy_parse")
    res = lz._select_sequences(marks, valid, mlen, moff, B, MAXSEQ)
    mark("select_sequences")
    return res


def _sizes(B: int, G: int) -> Tuple[int, int, int]:
    """(OUTCAP, MAXSEQ, MAXPIECE) of an encoder."""
    MAXSEQ = (B // max(G, MIN_MATCH)) + 2
    return out_capacity(B), MAXSEQ, MAXSEQ + B // 255 + 2


def make_encoder(block_size: int, G: int = 0):
    """The batched static encoder: (blocks uint8[N, B], lens int32[N],
    mark=...) -> (chunks uint8[N, OUTCAP], chunk sizes int32[N]).
    mark(stage) is called after "find_matches", the parse's stages and
    "emit"."""
    B = block_size
    OUTCAP, MAXSEQ, MAXPIECE = _sizes(B, G)

    def encode(blocks, lens, mark=_no_mark):
        pos, ml, off, nseq = _parse(blocks, lens, B, MAXSEQ, G, mark)
        res = _emit_deflate(blocks, pos, ml, off, nseq, lens, B, OUTCAP,
                            MAXSEQ, MAXPIECE)
        mark("emit")
        return res

    return encode


def make_encoder_dyn(block_size: int, G: int = 0):
    """The batched dynamic encoder: (blocks uint8[N, B], lens int32[N],
    mark=...) -> (bodies uint8[N, OUTCAP], body_bits int32[N], nb_lit
    int32[N, 288], nb_dist int32[N, 32], ok bool[N])."""
    B = block_size
    OUTCAP, MAXSEQ, MAXPIECE = _sizes(B, G)

    def encode(blocks, lens, mark=_no_mark):
        pos, ml, off, nseq = _parse(blocks, lens, B, MAXSEQ, G, mark)
        return _emit_deflate_dyn(blocks, pos, ml, off, nseq, lens, B, OUTCAP,
                                 MAXSEQ, MAXPIECE, mark)

    return encode


# --- host side of the dynamic path -------------------------------------------

_CL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1,
             15]


class _BitW:
    """LSB-first bit accumulator (deflate bit order)."""

    def __init__(self):
        self.acc = 0
        self.n = 0

    def put(self, v: int, nb: int):
        self.acc |= (v & ((1 << nb) - 1)) << self.n
        self.n += nb

    def bytes_bits(self):
        nbytes = (self.n + 7) // 8
        return self.acc.to_bytes(nbytes, "little"), self.n


def _limited_lengths(freq, maxlen: int):
    """Kraft-exact length-limited lengths (host mirror of _kraft_lengths,
    for the 19-symbol code-length code)."""
    total = sum(freq) or 1
    size = 1 << maxlen
    nb = [0] * len(freq)
    for s, f in enumerate(freq):
        if f:
            share = max(1, f * size // total)
            nb[s] = max(1, min(maxlen, maxlen - share.bit_length() + 1))
    D = size - sum(1 << (maxlen - l) for l in nb if l)
    order = sorted((s for s in range(len(freq)) if freq[s]),
                   key=lambda s: -freq[s])
    for s in order:  # shorten most frequent while deficit remains
        while D > 0 and nb[s] > 1:
            c = 1 << (maxlen - nb[s])
            if c > D:
                break
            D -= c
            nb[s] -= 1
    if D != 0:
        raise ValueError("code-length code: Kraft fixup failed")
    return nb


def _canon_host(nb, maxlen):
    bl = [0] * (maxlen + 1)
    for l in nb:
        if l:
            bl[l] += 1
    nc = [0] * (maxlen + 1)
    c = 0
    for l in range(1, maxlen + 1):
        c = (c + bl[l - 1]) << 1
        nc[l] = c
    bl[0] = 0
    codes = [0] * len(nb)
    for s, l in enumerate(nb):
        if l:
            codes[s] = nc[l]
            nc[l] += 1
    # bit-reverse for LSB-first emission
    return [int(format(codes[s], f"0{nb[s]}b")[::-1], 2) if nb[s] else 0
            for s in range(len(nb))]


def _rle_code_lengths(seq):
    """RFC 1951 RLE of the code-length sequence with symbols 16/17/18."""
    out = []
    i = 0
    n = len(seq)
    while i < n:
        v = seq[i]
        j = i
        while j < n and seq[j] == v:
            j += 1
        run = j - i
        if v == 0:
            while run >= 3:
                take = min(run, 138)
                if take < 11:
                    take = min(take, 10)
                    out.append((17, take - 3, 3))
                else:
                    out.append((18, take - 11, 7))
                run -= take
            out.extend([(0, 0, 0)] * run)
        else:
            out.append((v, 0, 0))
            run -= 1
            while run >= 3:
                take = min(run, 6)
                out.append((16, take - 3, 2))
                run -= take
            out.extend([(v, 0, 0)] * run)
        i = j
    return out


def _dyn_header(nb_lit, nb_dist):
    """Dynamic-block header bits (BFINAL=0, BTYPE=10, HLIT/HDIST/HCLEN +
    CL-coded code lengths). Returns (bytes, nbits)."""
    hlit = 257
    for s in range(285, -1, -1):
        if nb_lit[s]:
            hlit = max(257, s + 1)
            break
    hdist = 2
    for s in range(29, -1, -1):
        if nb_dist[s]:
            hdist = max(2, s + 1)
            break
    seq = [int(x) for x in nb_lit[:hlit]] + [int(x) for x in
                                             nb_dist[:hdist]]
    rle = _rle_code_lengths(seq)
    clfreq = [0] * 19
    for sym, _, _ in rle:
        clfreq[sym] += 1
    if sum(1 for f in clfreq if f) < 2:  # complete code needs 2 symbols
        clfreq[0 if rle and rle[0][0] != 0 else 8] += 1
    cl_nb = _limited_lengths(clfreq, 7)
    cl_code = _canon_host(cl_nb, 7)
    hclen = 4
    for k in range(18, -1, -1):
        if cl_nb[_CL_ORDER[k]]:
            hclen = max(4, k + 1)
            break
    bw = _BitW()
    bw.put(0, 1)          # BFINAL
    bw.put(2, 2)          # BTYPE = dynamic
    bw.put(hlit - 257, 5)
    bw.put(hdist - 1, 5)
    bw.put(hclen - 4, 4)
    for k in range(hclen):
        bw.put(cl_nb[_CL_ORDER[k]], 3)
    for sym, extra, ebits in rle:
        bw.put(cl_code[sym], cl_nb[sym])
        if ebits:
            bw.put(extra, ebits)
    return bw.bytes_bits()


def _splice_dyn(hdr: bytes, hbits: int, body: np.ndarray,
                body_bits: int) -> bytes:
    """Concatenate header bits + body bits (body emitted at offset 0) and
    close with the empty stored sync block — all-zero pad bits double as
    the stored block's BFINAL/BTYPE. Reads body[:ceil(body_bits / 8) + 1]
    at most."""
    total_bits = hbits + int(body_bits)
    nb_total = (total_bits + 3 + 7) // 8   # + stored-block header bits
    s = hbits & 7
    hfull = hbits // 8
    nbody = (int(body_bits) + 7) // 8
    out = bytearray(nb_total)
    out[:hfull] = hdr[:hfull]
    if s == 0:
        out[hfull:hfull + nbody] = body[:nbody].tobytes()
    else:
        b = body[:nbody + 1].astype(np.uint16)
        lo = ((b << s) & 0xFF).astype(np.uint8)
        hi = (b >> (8 - s)).astype(np.uint8)
        first = (hdr[hfull] if hfull < len(hdr) else 0) | int(lo[0])
        out[hfull] = first
        span = min(nbody, nb_total - hfull - 1)
        merged = (lo[1:span + 1] | hi[:span]).tobytes()
        out[hfull + 1:hfull + 1 + span] = merged
    return bytes(out) + SYNC_FLUSH


# --- host-facing batch helpers (bytes in / bytes out) -------------------------

def encode_blocks(blocks: Sequence[bytes], accel: int = 1, *, device,
                  mark=_no_mark, bucket=None) -> List[bytes]:
    """Compress blocks on `device` into sync-flushed raw-deflate chunks of
    one static block each; their concatenation (+ FINAL_BLOCK) is a valid
    deflate stream. mark(stage) is called on the host at "start", after
    the upload ("h2d"), and at the encoder's and the fetch's stage
    marks. bucket: lz4_device.upload_blocks'."""
    from . import compact
    arr, lens, B, G = lz.upload_blocks(blocks, accel, device, mark, bucket)
    out, sizes = make_encoder(B, G)(arr, lens, mark=mark)
    return compact.fetch_chunks(out, sizes, mark=mark)


def encode_blocks_dyn(blocks: Sequence[bytes], accel: int = 1, *, device,
                      mark=_no_mark, bucket=None):
    """Dynamic-Huffman encode on `device`: per-block litlen/dist codes,
    chunks with the static path's sync-flushed contract. Returns (chunks,
    failed): failed lists the blocks whose Kraft fixup failed, with None
    chunks; the codec tier re-encodes them statically.

    The fetch compacts each body to the min(ceil(body_bits / 8) + 1,
    OUTCAP) bytes _splice_dyn reads, instead of copying the whole (N,
    OUTCAP) buffer to the host as the JAX package does; the chunks are the
    same. mark(stage) as encode_blocks, plus the emitter's stages and
    "header_splice" after the host's headers and splices. bucket:
    lz4_device.upload_blocks'."""
    from . import compact
    arr, lens, B, G = lz.upload_blocks(blocks, accel, device, mark, bucket)
    out, body_bits, nb_lit, nb_dist, ok = make_encoder_dyn(B, G)(
        arr, lens, mark=mark)
    OUTCAP = out.shape[1]
    sizes = torch.clamp((body_bits + 7) // 8 + 1, max=OUTCAP).to(_I32)
    bodies = compact.fetch_chunks(out, sizes, mark=mark)
    meta = torch.cat([body_bits[:, None], ok[:, None].to(_I32), nb_lit,
                      nb_dist], dim=1).cpu().numpy()
    chunks: List[Optional[bytes]] = []
    failed = []
    for i, row in enumerate(meta):
        if not row[1]:
            chunks.append(None)
            failed.append(i)
            continue
        hdr, hbits = _dyn_header(row[2:2 + _NLIT], row[2 + _NLIT:])
        chunks.append(_splice_dyn(hdr, hbits,
                                  np.frombuffer(bodies[i], np.uint8),
                                  int(row[0])))
    mark("header_splice")
    return chunks, failed
