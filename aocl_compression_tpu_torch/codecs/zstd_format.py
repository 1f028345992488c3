"""zstd frame/block format primitives — constants + a scalar reference
writer for the device zstd encoder (ops/zstd_device.py).

The port's own copy of aocl_compression_tpu/codecs/zstd_format.py (pure
Python; the port imports nothing of the JAX package).

Implements, from RFC 8878 (behavior cross-checked against zstd's
reference decoder, lib/decompress/*):

  - predefined FSE distributions and encode tables for literal-length,
    match-length and offset codes (RFC §3.1.1.3.2.2),
  - a FIXED universal literal Huffman table (all 256 symbols present, depth
    <= 11) with its FSE-compressed tree description precomputed once —
    per-block optimal tables are a later milestone; a fixed table keeps the
    device pipeline free of per-block table construction,
  - the interleaved-state FSE sequence bitstream (encode backwards, two
    extra-bit fields per sequence, states flushed last),
  - 4-stream Huffman-compressed literals sections with jump table,
  - block and frame assembly with raw-block fallback (a compressed block
    must be strictly smaller than its regenerated content).

Everything bit-level here is boiled down to table constants + cumsum-able
bit widths so the device encoder can reuse it; `encode_frame` is the scalar
oracle the device path is tested against.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

MAGIC = 0xFD2FB528

# --- predefined FSE distributions (RFC 8878 §3.1.1.3.2.2) ---------------------
LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2,
              2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1]
OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, -1, -1, -1, -1, -1]
LL_LOG, ML_LOG, OF_LOG = 6, 6, 5

LL_BASE = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20,
           22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
           16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13,
                      14, 15, 16]
ML_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
           21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37,
           39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
           4099, 8195, 16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                      13, 14, 15, 16]


def ll_code_of(ll: int) -> int:
    if ll < 16:
        return ll
    for c in range(35, 15, -1):
        if ll >= LL_BASE[c]:
            return c
    return 16


def ml_code_of(ml: int) -> int:
    for c in range(52, -1, -1):
        if ml >= ML_BASE[c]:
            return c
    raise ValueError(ml)


# --- FSE encode tables ---------------------------------------------------------

def fse_spread_symbols(dist, tablelog):
    size = 1 << tablelog
    table = [-1] * size
    hi = size - 1
    for s, p in enumerate(dist):
        if p == -1:
            table[hi] = s
            hi -= 1
    pos = 0
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    for s, p in enumerate(dist):
        for _ in range(max(p, 0)):
            table[pos] = s
            pos = (pos + step) & mask
            while pos > hi:
                pos = (pos + step) & mask
    assert pos == 0 and all(t >= 0 for t in table)
    return table


def fse_build_encode(dist, tablelog):
    """(next_state_table, symbol_tt) like FSE_buildCTable."""
    size = 1 << tablelog
    table = fse_spread_symbols(dist, tablelog)
    freq = [abs(p) for p in dist]
    cumul = [0]
    for f in freq:
        cumul.append(cumul[-1] + f)
    nxt = [0] * size
    cum = cumul[:]
    for st in range(size):
        s = table[st]
        nxt[cum[s]] = size + st
        cum[s] += 1
    symbol_tt = []
    total = 0
    for s, f in enumerate(freq):
        if f == 0:
            symbol_tt.append((0, 0))
            continue
        if f == 1:
            delta_nb = (tablelog << 16) - (1 << tablelog)
            delta_fs = total - 1
        else:
            # maxBitsOut = tableLog - highbit32(f-1)
            max_bits_out = tablelog - ((f - 1).bit_length() - 1)
            min_state_plus = f << max_bits_out
            delta_nb = (max_bits_out << 16) - min_state_plus
            delta_fs = total - f
        symbol_tt.append((delta_nb, delta_fs))
        total += f
    return nxt, symbol_tt


class BitWriter:
    """Little-endian bit accumulation; stream closed with a 1 marker
    (read backwards by the decoder)."""

    def __init__(self):
        self.acc = 0
        self.n = 0
        self.out = bytearray()

    def add(self, value: int, nbits: int):
        self.acc |= (int(value) & ((1 << nbits) - 1)) << self.n
        self.n += nbits
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def close(self) -> bytes:
        self.add(1, 1)
        if self.n:
            self.out.append(self.acc & 0xFF)
            self.acc = 0
            self.n = 0
        return bytes(self.out)


class FSEEncoder:
    """Mirrors FSE_initCState2 / FSE_encodeSymbol / FSE_flushCState."""

    def __init__(self, dist, tablelog):
        self.nxt, self.tt = fse_build_encode(dist, tablelog)
        self.log = tablelog
        self.state = 0

    def init_state(self, sym: int):
        dnb, dfs = self.tt[sym]
        nbout = (dnb + (1 << 15)) >> 16
        self.state = self.nxt[(((nbout << 16) - dnb) >> nbout) + dfs]

    def encode(self, bw: BitWriter, sym: int):
        dnb, dfs = self.tt[sym]
        nbits = (self.state + dnb) >> 16
        bw.add(self.state, nbits)
        self.state = self.nxt[(self.state >> nbits) + dfs]

    def flush(self, bw: BitWriter):
        bw.add(self.state - (1 << self.log), self.log)


# --- FSE normalized-count header (FSE_writeNCount semantics) -------------------

def write_ncount(norm, tablelog) -> bytes:
    bw_bits = 0
    bw_cnt = 0
    out = bytearray()

    def put(v, n):
        nonlocal bw_bits, bw_cnt
        bw_bits |= (v & ((1 << n) - 1)) << bw_cnt
        bw_cnt += n
        while bw_cnt >= 16:
            out.append(bw_bits & 0xFF)
            out.append((bw_bits >> 8) & 0xFF)
            bw_bits >>= 16
            bw_cnt -= 16

    put(tablelog - 5, 4)
    remaining = (1 << tablelog) + 1
    threshold = 1 << tablelog
    nbbits = tablelog + 1
    s = 0
    prev_is0 = False
    while s < len(norm) and remaining > 1:
        if prev_is0:
            start = s
            while s < len(norm) and norm[s] == 0:
                s += 1
            assert s < len(norm), "trailing zeros with remaining > 1"
            while s >= start + 24:
                start += 24
                put(0xFFFF, 16)
            while s >= start + 3:
                start += 3
                put(3, 2)
            put(s - start, 2)
        count = norm[s]
        s += 1
        maxv = (2 * threshold - 1) - remaining
        remaining -= -count if count < 0 else count
        count += 1
        if count >= threshold:
            count += maxv
        put(count, nbbits - (1 if count < maxv else 0))
        prev_is0 = count == 1
        while remaining < threshold:
            nbbits -= 1
            threshold >>= 1
    assert remaining == 1
    if bw_cnt:
        out.append(bw_bits & 0xFF)
        if bw_cnt > 8:
            out.append((bw_bits >> 8) & 0xFF)
    return bytes(out)


# --- fixed universal literal Huffman table -------------------------------------

def _fixed_literal_lengths() -> List[int]:
    """ARITHMETIC code-length classes (so the device encoder derives
    (code, nbits) per byte with range compares, no table gathers):

      7 bits: [0x20,0x40) + [0x60,0x80)  (space/digits/punct, lowercase)
      8 bits: [0x00,0x20) + [0x40,0x60)  (control, uppercase)
      9 bits: [0x80,0x100)               (high half)

    Kraft sum: 64/128 + 64/256 + 128/512 = 1 exactly.
    """
    nb = []
    for b in range(256):
        if 0x20 <= b < 0x40 or 0x60 <= b < 0x80:
            nb.append(7)
        elif b < 0x80:
            nb.append(8)
        else:
            nb.append(9)
    return nb


def _normalize_weights(wt_freqs, total, tablelog):
    """FSE_normalizeCount-style: largest-share normalization to 2^tablelog
    (no low-prob -1 entries: useLowProbCount=0 gives >=1 slots)."""
    scale = 1 << tablelog
    norm = [0] * len(wt_freqs)
    acc = 0
    for s, f in enumerate(wt_freqs):
        if f == 0:
            continue
        n = max(1, (f * scale) // total)
        norm[s] = n
        acc += n
    # fix to exact sum on the largest symbol
    big = max(range(len(wt_freqs)), key=lambda s: wt_freqs[s])
    norm[big] += scale - acc
    assert norm[big] > 0
    return norm


def build_fixed_huffman():
    """Returns (nbits[256], codes[256], tree_desc_bytes, huff_log)."""
    nbits = _fixed_literal_lengths()
    huff_log = max(nbits)
    assert huff_log <= 11, huff_log
    weights = [huff_log + 1 - nb for nb in nbits]

    # canonical codes exactly like HUF_readCTable: longest codes get values
    # from 0, assigned in natural symbol order within a rank; each shorter
    # rank continues at (min >>= 1)
    per_rank = [0] * (huff_log + 2)
    for nb in nbits:
        per_rank[nb] += 1
    val_per_rank = [0] * (huff_log + 2)
    mn = 0
    for nb in range(huff_log, 0, -1):
        val_per_rank[nb] = mn
        mn += per_rank[nb]
        mn >>= 1
    codes = [0] * 256
    nxt = val_per_rank[:]
    for s in range(256):
        codes[s] = nxt[nbits[s]]
        nxt[nbits[s]] += 1

    # tree description: FSE-compressed weight sequence for symbols 0..254
    wseq = weights[:255]
    wt_freqs = [0] * (max(wseq) + 1)
    for w in wseq:
        wt_freqs[w] += 1
    wlog = 6
    while (1 << wlog) > 2 * len(wseq):
        wlog -= 1
    norm = _normalize_weights(wt_freqs, len(wseq), wlog)
    hdr = write_ncount(norm, wlog)
    enc = FSEEncoder(norm, wlog)
    bw = BitWriter()
    seq = wseq
    n = len(seq)
    e1, e2 = FSEEncoder(norm, wlog), FSEEncoder(norm, wlog)
    i = n
    if n & 1:
        e1.init_state(seq[i - 1])
        e2.init_state(seq[i - 2])
        e1.encode(bw, seq[i - 3])
        i -= 3
    else:
        e2.init_state(seq[i - 1])
        e1.init_state(seq[i - 2])
        i -= 2
    while i > 0:
        e2.encode(bw, seq[i - 1])
        e1.encode(bw, seq[i - 2])
        i -= 2
    e2.flush(bw)
    e1.flush(bw)
    stream = bw.close()
    blob = hdr + stream
    assert 1 < len(blob) < 128, len(blob)
    tree_desc = bytes([len(blob)]) + blob
    return nbits, codes, tree_desc, huff_log


LIT_NBITS, LIT_CODES, TREE_DESC, HUF_LOG = build_fixed_huffman()

# --- static FSE table for PER-BLOCK Huffman weight streams ---------------------
# Per-block tables compress their 255-entry weight sequence with this fixed
# weight-value distribution (every weight 0..11 representable), so only the
# bitstream varies per block and the table description is a constant.
WEIGHT_DIST = [24, 2, 2, 2, 3, 4, 5, 6, 6, 4, 3, 3]  # sums to 64
WEIGHT_LOG = 6
assert sum(WEIGHT_DIST) == 1 << WEIGHT_LOG
WEIGHT_DESC = write_ncount(WEIGHT_DIST, WEIGHT_LOG)


def encode_weight_stream(weights: Sequence[int]) -> bytes:
    """Scalar two-state FSE encode of a 255-entry weight sequence with the
    static WEIGHT_DIST table (FSE_compress_usingCTable semantics) — the
    oracle for the device implementation."""
    seq = list(weights)
    assert len(seq) == 255
    e1 = FSEEncoder(WEIGHT_DIST, WEIGHT_LOG)
    e2 = FSEEncoder(WEIGHT_DIST, WEIGHT_LOG)
    bw = BitWriter()
    i = len(seq)
    # odd length: init c1, c2, then c1 encodes one
    e1.init_state(seq[i - 1])
    e2.init_state(seq[i - 2])
    e1.encode(bw, seq[i - 3])
    i -= 3
    while i > 0:
        e2.encode(bw, seq[i - 1])
        e1.encode(bw, seq[i - 2])
        i -= 2
    e2.flush(bw)
    e1.flush(bw)
    return bw.close()


# --- scalar block/frame writer (the oracle) ------------------------------------

def _huff_stream(data: bytes) -> bytes:
    bw = BitWriter()
    for b in reversed(data):
        bw.add(LIT_CODES[b], LIT_NBITS[b])
    return bw.close()


def encode_literals_section(lit: bytes) -> bytes:
    """4-stream Huffman literals section (falls back to raw type)."""
    L = len(lit)
    if L >= 6:
        s1 = (L + 3) >> 2
        parts = [lit[0:s1], lit[s1:2 * s1], lit[2 * s1:3 * s1],
                 lit[3 * s1:]]
        streams = [_huff_stream(p) for p in parts]
        jump = struct.pack("<HHH", len(streams[0]), len(streams[1]),
                           len(streams[2]))
        body = TREE_DESC + jump + b"".join(streams)
        C = len(body)
        if C < L and max(len(s) for s in streams[:3]) < 65536:
            # size_format 11: 18-bit sizes, 5-byte header, type Compressed=2
            h = 2 | (3 << 2) | (L << 4) | (C << 22)
            return h.to_bytes(5, "little") + body
    # raw literals
    if L < 32:
        return bytes([(L << 3) | 0]) + lit
    if L < 4096:
        return (((L << 4) | (1 << 2) | 0).to_bytes(2, "little")) + lit
    return ((0 | (3 << 2) | (L << 4)).to_bytes(3, "little")) + lit


def encode_sequences_section(seqs: Sequence[Tuple[int, int, int]]) -> bytes:
    """seqs = [(lit_len, match_len, offset)] — predefined-FSE bitstream."""
    out = bytearray()
    n = len(seqs)
    if n < 128:
        out.append(n)
    elif n < 0x7F00:
        out.append((n >> 8) + 0x80)
        out.append(n & 0xFF)
    else:
        out.append(0xFF)
        out += struct.pack("<H", n - 0x7F00)
    if n == 0:
        return bytes(out)
    out.append(0)  # predefined modes for LL/OF/ML
    llE = FSEEncoder(LL_DEFAULT, LL_LOG)
    ofE = FSEEncoder(OF_DEFAULT, OF_LOG)
    mlE = FSEEncoder(ML_DEFAULT, ML_LOG)
    codes = []
    for (ll, ml, off) in seqs:
        ov = off + 3                      # no repcode usage
        ofc = ov.bit_length() - 1
        llc = ll_code_of(ll)
        mlc = ml_code_of(ml)
        codes.append((llc, ll - LL_BASE[llc], LL_BITS[llc],
                      mlc, ml - ML_BASE[mlc], ML_BITS[mlc],
                      ofc, ov - (1 << ofc)))
    bw = BitWriter()
    llc, llx, llb, mlc, mlx, mlb, ofc, ofx = codes[-1]
    llE.init_state(llc)
    ofE.init_state(ofc)
    mlE.init_state(mlc)
    bw.add(llx, llb)
    bw.add(mlx, mlb)
    bw.add(ofx, ofc)
    for i in range(n - 2, -1, -1):
        llc, llx, llb, mlc, mlx, mlb, ofc, ofx = codes[i]
        ofE.encode(bw, ofc)
        mlE.encode(bw, mlc)
        llE.encode(bw, llc)
        bw.add(llx, llb)
        bw.add(mlx, mlb)
        bw.add(ofx, ofc)
    mlE.flush(bw)
    ofE.flush(bw)
    llE.flush(bw)
    out += bw.close()
    return bytes(out)


def encode_frame(data: bytes, seqs, literals: bytes) -> bytes:
    """One single-block zstd frame; raw-block fallback when not smaller."""
    n = len(data)
    lit_sec = encode_literals_section(literals)
    seq_sec = encode_sequences_section(seqs)
    block = lit_sec + seq_sec

    out = bytearray(struct.pack("<I", MAGIC))
    if n < 256:
        out += bytes([0x20, n])
    elif n < 65536 + 256:
        out += bytes([0x60]) + struct.pack("<H", n - 256)
    else:
        out += bytes([0xA0]) + struct.pack("<I", n)

    if len(block) < n:
        bh = (len(block) << 3) | (2 << 1) | 1
        out += bh.to_bytes(3, "little") + block
    else:  # raw block (also required: compressed blocks must be < content)
        bh = (n << 3) | (0 << 1) | 1
        out += bh.to_bytes(3, "little") + data
    return bytes(out)
