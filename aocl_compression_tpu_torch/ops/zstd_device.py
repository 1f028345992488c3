"""zstd encoder as a batched tensor pipeline (tier TORCH).

The port of aocl_compression_tpu/ops/zstd_device.py: format-exact zstd
frames, one single-block frame per input block, built on the device:
  - the LZ4 pipelines' matcher at depth 8 and the tile parse (G = 4,
    level <= 2) or the exact parse (G = 0, level >= 3) (ops/lz4_device.py);
  - the literal stream compacted by one sort;
  - a per-block Huffman literal table (_block_huffman: log2-share lengths,
    the Kraft deficit absorbed over the frequency-sorted symbols), its
    255-weight description FSE-coded with a static table (_encode_weights);
    the absorb and the weight encode are the hand kernels kraft_absorb and
    weights_fse_encode (csrc/entropy_scan.cu) on CUDA, plain loops on the
    CPU;
  - 4-stream Huffman literals: bit offsets from one reverse cumsum, the
    codes scatter-added into 32-bit words of per-stream regions;
  - per-block FSE sequence tables (custom when cheaper than the predefined
    ones) and the 3-state reverse FSE scan (_fse_scan: the hand kernel
    csrc/zstd_scan.cu on CUDA, its plain loop on the CPU), whose (value,
    nbits) pieces one cumsum places in the sequence bitstream;
  - the compaction kernel fetches the streams and sections, the host
    assembles the frames.

Every function takes a batch as (N, ...) tensors on one device and returns
what the JAX function returns for each block, bit for bit. uint32 words are
int64 holding the 32-bit pattern; packed pieces never overlap, so add
equals or. Scatters with the JAX package's mode="drop" use the deflate
slice's spare-slot _scatter_add. The JAX package's scatter-free bit pack
(ops/bitpack.py, AOCL_ZSTD_PACK=ladder) exists to avoid scatters on the
TPU and is not ported.
"""

from __future__ import annotations

import functools
import struct
from typing import Sequence

import numpy as np
import torch

from ..codecs import zstd_format as ZF
from . import lz4_device as lz
from .compact import _no_mark
from .deflate_device import (_floor_log2, _kraft_absorb, _pow2,
                             _scatter_add)
from .lz4_device import _I32, MIN_MATCH, _arange

WCAP = 512
_NSYM_PAD = 64  # padded symbol axis (LL 36, ML 53, OF 32 all fit)
_CUSTOM_LOG = {"ll": 9, "of": 8, "ml": 9}


def _tt_arrays(tt, width=None):
    n = width or len(tt)
    dnb = np.zeros(n, np.int32)
    dfs = np.zeros(n, np.int32)
    for s, (a, b) in enumerate(tt):
        dnb[s], dfs[s] = a, b
    return dnb, dfs


def _pad_nxt(nxt, width: int = 512):
    a = np.zeros(width, np.int32)
    a[:len(nxt)] = nxt
    return a


def _cost_table(dist, tablelog):
    """bits/occurrence per symbol under a static FSE distribution (f32)."""
    c = np.full(_NSYM_PAD, 0.0, np.float32)
    for s, p in enumerate(dist):
        c[s] = tablelog - np.log2(max(abs(p), 0.5))
    return c


@functools.lru_cache(maxsize=8)
def _visit_order(tablelog: int):
    size = 1 << tablelog
    step = (size >> 1) + (size >> 3) + 3
    return tuple(int(x) for x in (np.arange(size) * step) % size)


def _host_tables():
    """The constant tables as numpy arrays."""
    t = {}
    for f, dist, log in (("ll", ZF.LL_DEFAULT, ZF.LL_LOG),
                         ("ml", ZF.ML_DEFAULT, ZF.ML_LOG),
                         ("of", ZF.OF_DEFAULT, ZF.OF_LOG)):
        nxt, tt = ZF.fse_build_encode(dist, log)
        t[f"{f}_nxt"] = _pad_nxt(nxt)
        t[f"{f}_dnb"], t[f"{f}_dfs"] = _tt_arrays(tt, _NSYM_PAD)
        t[f"{f}_cost"] = _cost_table(dist, log)
    w_nxt, w_tt = ZF.fse_build_encode(ZF.WEIGHT_DIST, ZF.WEIGHT_LOG)
    t["w_nxt"] = np.asarray(w_nxt, np.int32)
    t["w_dnb"], t["w_dfs"] = _tt_arrays(w_tt)
    for name, v in (("ll_base", ZF.LL_BASE), ("ll_bits", ZF.LL_BITS),
                    ("ml_base", ZF.ML_BASE), ("ml_bits", ZF.ML_BITS)):
        t[name] = np.asarray(v, np.int32)
    for log in set(_CUSTOM_LOG.values()):
        t[f"visit{log}"] = np.asarray(_visit_order(log), np.int64)
    return t


@functools.lru_cache(maxsize=4)
def _consts(device) -> dict:
    """The constant tables on `device`."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in _host_tables().items()}


def stream_cap(block_size: int) -> int:
    n = ((block_size + 3) // 4) * 11 // 8 + 16   # codes are <= 11 bits
    return -(-n // 512) * 512  # compaction row quantum (ops/compact.py)


def seq_cap(maxseq: int) -> int:
    # worst case per sequence: states 9+8+9 (custom logs) + extras
    # llx<=16, mlx<=16, ofx<=16 bits = 74 bits -> 10 bytes covers it
    n = maxseq * 10 + 16
    return -(-n // 512) * 512


def _words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """(N, K) int64 holding uint32 words -> (N, 4K) uint8, little-endian."""
    return torch.stack([(w >> s) & 0xFF for s in (0, 8, 16, 24)],
                       dim=2).reshape(w.shape[0], -1).to(torch.uint8)


# =============================================================================
# Literal Huffman table
# =============================================================================

def _block_huffman(lits32, nlits):
    """Per-block length-limited Huffman tables (huffLog = 11, Kraft exact)
    for the literal rows lits32 (N, B) with nlits (N,) live entries.

    Returns (code (N, 256), nb (N, 256), weights (N, 255), ok (N,)). The
    JAX package's lax.sort by (-hist, sym) and its inverse are one sort of
    the unique key -hist * 256 + sym and a scatter by its permutation; its
    256-step lax.scan is deflate_device._kraft_absorb at MAXLEN 11."""
    N, B = lits32.shape
    dev = lits32.device
    j = _arange(B, dev)
    hist = torch.zeros((N, 256), dtype=_I32, device=dev)
    hist.scatter_add_(1, torch.clamp(lits32, 0, 255).long(),
                      (j < nlits[:, None]).to(_I32))
    hist[:, 255] = torch.clamp(hist[:, 255], min=1)  # implicit-last present
    present = hist > 0
    npres = present.sum(dim=1)
    share = torch.div(hist * 2048, torch.clamp(nlits, min=1)[:, None],
                      rounding_mode="floor")
    f = _floor_log2(torch.clamp(share, min=1), 12)
    nb = torch.where(present, torch.clamp(11 - f, 1, 11), 0)
    contrib = torch.where(present, _pow2(11 - torch.clamp(nb, min=1)), 0)
    D = 2048 - contrib.sum(dim=1, dtype=_I32)

    sym = _arange(256, dev)
    order = torch.sort(-hist.long() * 256 + sym, dim=1).indices
    nbs2, D = _kraft_absorb(torch.gather(nb, 1, order), D, 11)
    nb_final = torch.empty_like(nbs2).scatter_(1, order, nbs2)
    ok = (D == 0) & (npres >= 2)

    # huffLog = the longest code used; weights = huffLog + 1 - nb
    maxnb = nb_final.max(dim=1, keepdim=True).values
    weights = torch.where(nb_final > 0, maxnb + 1 - nb_final, 0)

    per_rank = torch.zeros((N, 13), dtype=_I32, device=dev)
    per_rank.scatter_add_(1, torch.clamp(nb_final, 0, 12).long(),
                          present.to(_I32))
    vpr = torch.zeros((N, 13), dtype=_I32, device=dev)
    mn = torch.zeros(N, dtype=_I32, device=dev)
    for r in range(11, 0, -1):
        vpr[:, r] = mn
        mn = (mn + per_rank[:, r]) >> 1
    rw = torch.zeros_like(nb_final)
    for r in range(1, 12):
        m = (nb_final == r).to(_I32)
        rw = rw + torch.where(nb_final == r, torch.cumsum(m, dim=1) - m, 0)
    code = torch.gather(vpr, 1, torch.clamp(nb_final, 0, 12).long()) + rw
    return code, nb_final, weights[:, :255], ok


def _encode_weights(weights):
    """Two-state FSE encode of each row's 255-entry weight sequence (N,
    255), int32 in [0, 12), with the static weight table: (buf (N, 512)
    uint8, size (N,) int32). A CUDA tensor runs the kernel
    weights_fse_encode (csrc/entropy_scan.cu), a CPU tensor the plain
    loop."""
    c = _consts(weights.device)
    if weights.is_cuda:
        from . import entropy_scan
        return entropy_scan.weights_fse_encode(
            weights.contiguous(), c["w_nxt"], c["w_dnb"], c["w_dfs"])
    if weights.device.type == "cpu":
        return _encode_weights_plain(weights)
    raise ValueError(f"_encode_weights: unsupported device {weights.device}")


def _encode_weights_plain(weights):
    """PyTorch version of weights_fse_encode: the JAX package's 126-step
    lax.scan as a loop of tensor ops over the N rows, then the bit pack."""
    N = weights.shape[0]
    dev = weights.device
    c = _consts(dev)
    wl = weights.long()
    dnb, dfs = c["w_dnb"][wl], c["w_dfs"][wl]
    WN = c["w_nxt"]

    def enc(state, i):
        nbits = (state + dnb[:, i]) >> 16
        val = state & (_pow2(nbits) - 1)
        return WN[((state >> nbits) + dfs[:, i]).long()], val, nbits

    def init(i):
        d = dnb[:, i]
        nbout = (d + (1 << 15)) >> 16
        return WN[((((nbout << 16) - d) >> nbout) + dfs[:, i]).long()]

    st1, st2 = init(254), init(253)
    st1, v0, n0 = enc(st1, 252)
    vs, ns = [v0], [n0]
    for t in range(126):   # pairs (e2 then e1) over indices 251..0
        st2, va, na = enc(st2, 251 - 2 * t)
        st1, vb, nbb = enc(st1, 250 - 2 * t)
        vs += [va, vb]
        ns += [na, nbb]
    L = torch.full_like(n0, ZF.WEIGHT_LOG)
    allv = torch.stack(vs + [st2 - (1 << ZF.WEIGHT_LOG),
                             st1 - (1 << ZF.WEIGHT_LOG)], dim=1)
    alln = torch.stack(ns + [L, L], dim=1)
    bpos = torch.cumsum(alln, dim=1, dtype=_I32) - alln
    total = alln.sum(dim=1, dtype=_I32)
    vals = (allv & (_pow2(alln) - 1)) << (bpos & 7)
    qb = torch.where(alln > 0, bpos >> 3, WCAP)
    buf = torch.zeros((N, WCAP + 1), dtype=_I32, device=dev)
    _scatter_add(buf, qb, vals & 0xFF)
    _scatter_add(buf, torch.clamp(qb + 1, max=WCAP), (vals >> 8) & 0xFF)
    _scatter_add(buf, (total >> 3)[:, None], _pow2(total & 7)[:, None])
    return buf[:, :WCAP].to(torch.uint8), (total + 1 + 7) >> 3


# =============================================================================
# Per-block FSE sequence tables
# =============================================================================

def _normalize_counts(counts, L: int):
    """counts (N, 64) int32 -> (norm, ok). Norm sums to 2^L, every present
    symbol >= 1, no -1 lowprob entries. The JAX package's stable argsort of
    -rem is one sort of the unique key -rem * 64 + sym."""
    N = counts.shape[0]
    dev = counts.device
    size = 1 << L
    sym = _arange(_NSYM_PAD, dev)
    total = torch.clamp(counts.sum(dim=1, dtype=_I32), min=1)[:, None]
    base = torch.div(counts * size, total, rounding_mode="floor")
    norm0 = torch.where(counts > 0, torch.clamp(base, min=1), 0)
    delta = size - norm0.sum(dim=1, keepdim=True, dtype=_I32)
    # delta > 0: +1 to the `delta` symbols with the largest remainders
    rem = counts * size - base * total
    key = torch.where(counts > 0, -rem, 1 << 30).long() * _NSYM_PAD + sym
    order = torch.sort(key, dim=1).indices
    rank = torch.empty_like(order).scatter_(1, order,
                                            sym.long().expand(N, -1))
    norm1 = torch.where(delta > 0,
                        norm0 + ((rank < delta) & (counts > 0)).to(_I32),
                        norm0)
    # remaining negative delta: steal from the largest (first) symbol
    d2 = size - norm1.sum(dim=1, dtype=_I32)
    am = torch.argmax(norm1, dim=1)
    norm = norm1.clone()
    norm[torch.arange(N, device=dev), am] += d2
    present = counts > 0
    ok = ((norm.sum(dim=1) == size) & (present.sum(dim=1) >= 2)
          & torch.all(torch.where(present, norm >= 1, norm == 0), dim=1))
    return norm, ok


def _fse_encode_tables(norm, L: int):
    """norm (N, 64) summing to 2^L -> (nxt (N, 512), dnb (N, 64), dfs).
    The spread of a table without low-probability entries visits slot
    k * step mod size for the k-th symbol occurrence, so it is one
    searchsorted and one scatter; the next-state table one sort."""
    N = norm.shape[0]
    dev = norm.device
    size = 1 << L
    inc = torch.cumsum(norm, dim=1, dtype=_I32)
    cumul = inc - norm
    k = _arange(size, dev).expand(N, size).contiguous()
    sym = torch.searchsorted(inc.contiguous(), k, right=True).to(_I32)
    V = _consts(dev)[f"visit{L}"].expand(N, size)
    table = torch.zeros((N, size), dtype=_I32, device=dev).scatter_(1, V, sym)
    skey = torch.sort(table * size + k, dim=1).values
    nxt = size + (skey & (size - 1))
    if size < 512:
        nxt = torch.cat([nxt, nxt.new_zeros(N, 512 - size)], dim=1)
    f = norm
    mbo = L - _floor_log2(torch.clamp(f - 1, min=1), L + 1)
    dnb = torch.where(f == 1, (L << 16) - (1 << L),
                      torch.where(f > 1, (mbo << 16) - (f << mbo), 0))
    dfs = torch.where(f == 1, cumul - 1, torch.where(f > 1, cumul - f, 0))
    return nxt, dnb.to(_I32), dfs.to(_I32)


def _choose_seq_table(codes, real, nseq, L: int, cost_predef, nsym: int):
    """Histogram + normalize + cost comparison for one field.

    Returns (use_custom (N,), norm, nxt, dnb, dfs); nxt/dnb/dfs are only
    valid where use_custom. The costs are float32 in the JAX package's
    expression, so a near-tie decides as it does there unless the sums
    round apart."""
    N = codes.shape[0]
    dev = codes.device
    counts = torch.zeros((N, _NSYM_PAD + 1), dtype=_I32, device=dev)
    _scatter_add(counts, torch.where(real, codes, _NSYM_PAD), 1)
    counts = counts[:, :_NSYM_PAD]
    norm, ok = _normalize_counts(counts, L)
    nxt, dnb, dfs = _fse_encode_tables(norm, L)
    cf = counts.to(torch.float32)
    bits_custom = torch.sum(cf * (L - torch.log2(
        torch.clamp(norm.to(torch.float32), min=0.5))), dim=1)
    maxs = torch.where(counts > 0, _arange(_NSYM_PAD, dev), 0).max(dim=1)
    hdr_bits = 16.0 + 6.0 * (maxs.values.to(torch.float32) + 1.0)
    bits_predef = torch.sum(cf * cost_predef, dim=1)
    # predefined tables only cover nsym symbols; codes beyond FORCE custom
    overflow = torch.any(counts[:, nsym:] > 0, dim=1)
    use = ok & (((nseq >= 32) & (bits_custom + hdr_bits < bits_predef))
                | overflow)
    return use, norm, nxt, dnb, dfs


# =============================================================================
# The FSE sequence scan
# =============================================================================

def _fse_scan(xs, nseq, nxt, dnb, dfs):
    """The 3-state reverse FSE scan of every block: step r encodes sequence
    nseq - 1 - r (the last one initializes the states). xs (N, MAXSEQ, 8)
    int32 [llc, llx, llb, mlc, mlx, mlb, ofc, ofx] in block order; tables
    nxt (N, 3, 512), dnb / dfs (N, 3, 64) for [ll, ml, of]. Returns (pv, pn)
    (N, MAXSEQ, 6) in processing order, [of, ml, ll, x_ll, x_ml, x_of]
    values and bit counts (zero rows past nseq), and the final [ll, ml, of]
    states (N, 3). A CUDA tensor runs the kernel fse_encode_scan, a CPU
    tensor the plain loop."""
    if xs.is_cuda:
        from . import zstd_scan
        return zstd_scan.fse_encode_scan(xs, nseq, nxt, dnb, dfs)
    if xs.device.type == "cpu":
        return _fse_scan_plain(xs, nseq, nxt, dnb, dfs)
    raise ValueError(f"_fse_scan: unsupported device {xs.device}")


def _tab(t, i, size):
    """t (N, size)[row, i] with the JAX package's gather semantics: a
    negative index counts from the end, then clamps."""
    i = torch.where(i < 0, i + size, i)
    return torch.gather(t, 1, torch.clamp(i, 0, size - 1).long()[:, None])[:, 0]


def _fse_scan_plain(xs, nseq, nxt, dnb, dfs):
    """PyTorch version of fse_encode_scan: one step of tensor ops per
    sequence over all N blocks, to the batch's largest nseq."""
    N, MAXSEQ, _ = xs.shape
    dev = xs.device
    rows = torch.arange(N, device=dev)
    tabs = [(nxt[:, f], dnb[:, f], dfs[:, f]) for f in range(3)]

    def init(f, c):
        tn, td, tf = tabs[f]
        d = _tab(td, c, _NSYM_PAD)
        nbout = (d + (1 << 15)) >> 16
        return _tab(tn, (((nbout << 16) - d) >> nbout) + _tab(tf, c, _NSYM_PAD),
                    512)

    def enc(f, state, c):
        tn, td, tf = tabs[f]
        nbits = (state + _tab(td, c, _NSYM_PAD)) >> 16
        val = state & (_pow2(nbits) - 1)
        new = _tab(tn, (state >> nbits) + _tab(tf, c, _NSYM_PAD), 512)
        return new, val, nbits

    pv = torch.zeros((N, MAXSEQ, 6), dtype=_I32, device=dev)
    pn = torch.zeros_like(pv)
    st = [torch.zeros(N, dtype=_I32, device=dev) for _ in range(3)]
    zero = st[0]
    for r in range(int(nseq.max()) if N else 0):
        real = r < nseq
        x = xs[rows, torch.clamp(nseq - 1 - r, min=0)]
        c_ll, x_ll, b_ll, c_ml, x_ml, b_ml, c_of, x_of = x.unbind(1)
        if r == 0:
            st = [torch.where(real, init(f, c), s)
                  for f, c, s in ((0, c_ll, st[0]), (1, c_ml, st[1]),
                                  (2, c_of, st[2]))]
            vn = [zero] * 6
        else:
            vn = []
            for f, c in ((2, c_of), (1, c_ml), (0, c_ll)):
                new, val, nbits = enc(f, st[f], c)
                st[f] = torch.where(real, new, st[f])
                vn += [val, nbits]
        v = torch.stack([vn[0], vn[2], vn[4], x_ll, x_ml, x_of], dim=1)
        n = torch.stack([vn[1], vn[3], vn[5], b_ll, b_ml, c_of], dim=1)
        pv[:, r] = torch.where(real[:, None], v, 0)
        pn[:, r] = torch.where(real[:, None], n, 0)
    return pv, pn, torch.stack(st, dim=1)


# =============================================================================
# The block encoder
# =============================================================================

def _encode_block(data_u8, n, B: int, MAXSEQ: int, G: int, SCAP: int,
                  QCAP: int, mark=_no_mark):
    """Encode a batch of blocks (N, B); returns, per block, what the JAX
    package's _encode_block returns: (litbuf (N, 4*SCAP) uint8, lit_sizes
    (N, 4), nlits, lits (N, B) uint8, seqbuf (N, QCAP) uint8, seq_size,
    nseq, wbuf (N, 512) uint8, wsize, tab_ok, fse_use (N, 3) [ll, of, ml],
    fse_norms (N, 3, 64) [ll, of, ml]). mark(stage) is called after each
    stage is enqueued: "find_matches", the parse's ("grid_parse", or
    "greedy_parse" and "select_sequences"), "literals", "huffman_table",
    "huffman_weights", "literal_pack", "seq_tables", "fse_scan",
    "seq_pack"."""
    dev = data_u8.device
    N = data_u8.shape[0]
    i64 = torch.int64
    c = _consts(dev)
    # depth-8 chain walk: zstd spends its budget on ratio
    mlen, moff, valid = lz._find_matches(data_u8, n, B, depth=8)
    mark("find_matches")
    if G:
        pos, ml, off, nseq = lz._grid_parse(mlen, moff, valid, B, G, MAXSEQ,
                                            match_cap=68)
        mark("grid_parse")
    else:
        marks = lz._greedy_parse(mlen, valid, B)
        mark("greedy_parse")
        pos, ml, off, nseq = lz._select_sequences(marks, valid, mlen, moff,
                                                  B, MAXSEQ)
        mark("select_sequences")
    del mlen, moff, valid

    idx = _arange(B, dev)
    real = _arange(MAXSEQ, dev) < nseq[:, None]
    ends = pos + ml

    # --- literal stream (compacted via one sort) ------------------------------
    cov = torch.zeros((N, B + 1), dtype=_I32, device=dev)
    _scatter_add(cov, torch.where(real, pos, B), 1)
    _scatter_add(cov, torch.where(real, ends, B), -1)
    is_lit = (torch.cumsum(cov[:, :B], dim=1) == 0) & (idx < n[:, None])
    nlits = is_lit.sum(dim=1, dtype=_I32)
    perm = torch.sort(torch.where(is_lit, idx, idx + B), dim=1).indices
    lits32 = torch.gather(data_u8, 1, perm).to(_I32)
    # per-seq literal lengths (prefix counts of literal bytes)
    litpsum = torch.cumsum(is_lit.to(_I32), dim=1, dtype=_I32)

    def pref(p):  # literals strictly before position p
        pc = torch.clamp(p - 1, 0, B - 1).long()
        return torch.where(p > 0, torch.gather(litpsum, 1, pc), 0)

    ll = torch.where(real, pref(pos) - pref(lz._shr(ends, 1, 0)), 0)
    mark("literals")

    # --- per-block Huffman table + 4-stream literals ----------------------------
    ctab, ntab, wts, tab_ok = _block_huffman(lits32, nlits)
    mark("huffman_table")
    wbuf, wsize = _encode_weights(wts)
    mark("huffman_weights")
    li = torch.clamp(lits32, 0, 255).long()
    code = torch.gather(ctab, 1, li)
    live = idx < nlits[:, None]
    nb = torch.where(live, torch.gather(ntab, 1, li), 0)
    s1 = (nlits + 3) >> 2
    t = torch.clamp(torch.where(s1[:, None] > 0, torch.div(
        idx, torch.clamp(s1, min=1)[:, None], rounding_mode="floor"), 0),
        max=3)
    # suffix sums of nb: S[j] = sum_{k >= j} nb[k]
    S = torch.cat([torch.cumsum(nb.flip(1), dim=1, dtype=_I32).flip(1),
                   nb.new_zeros(N, 1)], dim=1)
    bounds = torch.stack([torch.minimum(s1, nlits),
                          torch.minimum(2 * s1, nlits),
                          torch.minimum(3 * s1, nlits), nlits], dim=1)
    S_at_bound = torch.gather(S, 1, torch.clamp(bounds, 0, B).long())
    bitpos = S[:, 1:] - torch.gather(S_at_bound, 1, t.long())
    starts = torch.cat([bounds.new_zeros(N, 1), bounds[:, :3]], dim=1)
    Lbits = torch.gather(S, 1, torch.clamp(starts, 0, B).long()) - S_at_bound

    # word-granular packing: an 11-bit code shifted by < 32 spans at most
    # two 32-bit words
    SW = SCAP >> 2
    litw = torch.zeros((N, 4 * SW + 1), dtype=i64, device=dev)
    code_u = code.to(i64)
    shw = (bitpos & 31).to(i64)
    lo = (code_u << shw) & 0xFFFFFFFF
    hi = torch.where(shw == 0, 0, code_u >> (32 - shw))
    wb = torch.where(live, t * SW + (bitpos >> 5), 4 * SW)
    _scatter_add(litw, wb, lo)
    _scatter_add(litw, torch.where(live, wb + 1, 4 * SW), hi)
    mw = _arange(4, dev) * SW + (Lbits >> 5)     # end-of-stream markers
    _scatter_add(litw, mw, _pow2((Lbits & 31).to(i64)))
    litbuf = _words_to_bytes(litw[:, :4 * SW])
    lit_sizes = (Lbits + 1 + 7) >> 3
    mark("literal_pack")

    # --- sequence codes --------------------------------------------------------
    llc = (torch.searchsorted(c["ll_base"], ll, right=True) - 1).to(_I32)
    llx = ll - c["ll_base"][llc.long()]
    llb = c["ll_bits"][llc.long()]
    mlv = torch.clamp(ml, min=3)
    mlc = (torch.searchsorted(c["ml_base"], mlv, right=True) - 1).to(_I32)
    mlx = mlv - c["ml_base"][mlc.long()]
    mlb = c["ml_bits"][mlc.long()]
    # repeat-offset 1: an offset equal to the previous sequence's (the
    # initial rep[0] = 1 for the first) codes as Offset_Value 1, valid only
    # when litLength > 0
    use_rep1 = (ll > 0) & (off == lz._shr(off, 1, 1))
    ov = torch.where(use_rep1, 1, off + 3)
    ofc = _floor_log2(torch.clamp(ov, min=1), 18)
    ofx = ov - _pow2(ofc)

    # --- per-block FSE tables (the predefined ones when not cheaper) --------
    fields = {}
    for f, codes, nsym in (("ll", llc, 36), ("ml", mlc, 53), ("of", ofc, 29)):
        use, norm, nxt_c, dnb_c, dfs_c = _choose_seq_table(
            codes, real, nseq, _CUSTOM_LOG[f], c[f"{f}_cost"], nsym)
        u = use[:, None]
        fields[f] = (use, norm,
                     torch.where(u, nxt_c, c[f"{f}_nxt"]),
                     torch.where(u, dnb_c, c[f"{f}_dnb"]),
                     torch.where(u, dfs_c, c[f"{f}_dfs"]))
    log_ll = torch.where(fields["ll"][0], _CUSTOM_LOG["ll"], ZF.LL_LOG)
    log_ml = torch.where(fields["ml"][0], _CUSTOM_LOG["ml"], ZF.ML_LOG)
    log_of = torch.where(fields["of"][0], _CUSTOM_LOG["of"], ZF.OF_LOG)
    mark("seq_tables")

    # --- FSE scan (reverse order, 3 states) -----------------------------------
    xs = torch.stack([llc, llx, llb, mlc, mlx, mlb, ofc, ofx], dim=2)
    tabs = [torch.stack([fields[f][k] for f in ("ll", "ml", "of")], dim=1)
            .to(_I32).contiguous() for k in (2, 3, 4)]
    pv, pn, fin = _fse_scan(xs.to(_I32).contiguous(), nseq.to(_I32), *tabs)
    mark("fse_scan")

    fll, fml, fof = fin.unbind(1)
    flush_v = torch.stack([fml - _pow2(log_ml), fof - _pow2(log_of),
                           fll - _pow2(log_ll)], dim=1).to(_I32)
    flush_n = torch.where((nseq > 0)[:, None],
                          torch.stack([log_ml, log_of, log_ll], dim=1), 0)
    allv = torch.cat([pv.reshape(N, -1), flush_v], dim=1)
    alln = torch.cat([pn.reshape(N, -1), flush_n.to(_I32)], dim=1)
    bpos = torch.cumsum(alln, dim=1, dtype=_I32) - alln
    total_bits = alln.sum(dim=1, dtype=_I32)

    # word-granular sequence bitstream (2 scatters; see literals)
    QW = QCAP >> 2
    seqw = torch.zeros((N, QW + 1), dtype=i64, device=dev)
    v_u = (allv & (_pow2(alln) - 1)).to(i64) & 0xFFFFFFFF
    shq = (bpos & 31).to(i64)
    lo_q = (v_u << shq) & 0xFFFFFFFF
    hi_q = torch.where(shq == 0, 0, v_u >> (32 - shq))
    qw = torch.where(alln > 0, bpos >> 5, QW)
    _scatter_add(seqw, qw, lo_q)
    _scatter_add(seqw, torch.where(alln > 0, qw + 1, QW), hi_q)
    _scatter_add(seqw, torch.where(nseq > 0, total_bits >> 5, QW)[:, None],
                 _pow2((total_bits & 31).to(i64))[:, None])
    seqbuf = _words_to_bytes(seqw[:, :QW])
    seq_size = torch.where(nseq > 0, (total_bits + 1 + 7) >> 3, 0)
    mark("seq_pack")

    fse_use = torch.stack([fields[f][0] for f in ("ll", "of", "ml")], dim=1)
    fse_norms = torch.stack([fields[f][1] for f in ("ll", "of", "ml")],
                            dim=1).to(_I32)
    return (litbuf, lit_sizes.to(_I32), nlits, lits32.to(torch.uint8),
            seqbuf, seq_size.to(_I32), nseq.to(_I32), wbuf, wsize.to(_I32),
            tab_ok, fse_use, fse_norms)


def make_encoder(block_size: int, G: int = 0):
    """The batched encoder: (blocks uint8[N, B], lens int32[N], mark=...)
    -> _encode_block's tuple, on the device the inputs lie on."""
    B = block_size
    # cap the sequence domain at B/8: overflow only drops matches into
    # literals (format stays exact)
    MAXSEQ = min(B // max(G, MIN_MATCH), max(B // 8, 512)) + 2
    SCAP = stream_cap(B)
    QCAP = seq_cap(MAXSEQ)

    def encode(blocks, lens, mark=_no_mark):
        return _encode_block(blocks, lens, B, MAXSEQ, G, SCAP, QCAP, mark)

    return encode


# =============================================================================
# Host assembly
# =============================================================================

def _seq_table_headers(use_flags, norms) -> bytes:
    """Symbol_Compression_Modes byte + NCount headers for the custom
    (FSE_Compressed, mode 2) fields; predefined fields contribute no
    header (RFC 8878 §3.1.1.3.2.1; table order LL, OF, ML)."""
    use_ll, use_of, use_ml = (bool(x) for x in use_flags)
    modes = ((2 if use_ll else 0) << 6) | ((2 if use_of else 0) << 4) \
        | ((2 if use_ml else 0) << 2)
    out = bytearray([modes])
    for use, norm, log in ((use_ll, norms[0], _CUSTOM_LOG["ll"]),
                           (use_of, norms[1], _CUSTOM_LOG["of"]),
                           (use_ml, norms[2], _CUSTOM_LOG["ml"])):
        if not use:
            continue
        maxs = max(i for i, v in enumerate(norm) if v > 0)
        out += ZF.write_ncount([int(v) for v in norm[:maxs + 1]], log)
    return bytes(out)


def _assemble_frame(block: bytes, nlits: int, lits, streams, nseq: int,
                    seqsec_body: bytes, tree=None,
                    seq_headers: bytes = b"\x00") -> bytes:
    """Build one frame from device pieces; falls back to raw when bigger.
    `lits` is a zero-arg callable fetching the compacted literal bytes
    (only fallback blocks pay for it); `tree` is the per-block Huffman
    tree description (None -> raw literals)."""
    n = len(block)
    lit_sec = None
    if nlits >= 6 and tree is not None:
        jump = struct.pack("<HHH", len(streams[0]), len(streams[1]),
                           len(streams[2]))
        body = tree + jump + b"".join(streams)
        C = len(body)
        if C < nlits and max(len(s) for s in streams[:3]) < 65536:
            h = 2 | (3 << 2) | (nlits << 4) | (C << 22)
            lit_sec = h.to_bytes(5, "little") + body
    if lit_sec is None:  # raw literals
        L = nlits
        raw = lits()
        if L < 32:
            lit_sec = bytes([(L << 3)]) + raw
        elif L < 4096:
            lit_sec = ((L << 4) | (1 << 2)).to_bytes(2, "little") + raw
        else:
            lit_sec = ((3 << 2) | (L << 4)).to_bytes(3, "little") + raw

    if nseq == 0:
        seq_sec = b"\x00"
    else:
        if nseq < 128:
            head = bytes([nseq])
        elif nseq < 0x7F00:
            head = bytes([(nseq >> 8) + 0x80, nseq & 0xFF])
        else:
            head = b"\xff" + struct.pack("<H", nseq - 0x7F00)
        seq_sec = head + seq_headers + seqsec_body

    blk = lit_sec + seq_sec
    out = bytearray(struct.pack("<I", ZF.MAGIC))
    if n < 256:
        out += bytes([0x20, n])
    elif n < 65536 + 256:
        out += bytes([0x60]) + struct.pack("<H", n - 256)
    else:
        out += bytes([0xA0]) + struct.pack("<I", n)
    if len(blk) < n:
        out += ((len(blk) << 3) | (2 << 1) | 1).to_bytes(3, "little") + blk
    else:
        out += ((n << 3) | 1).to_bytes(3, "little") + block
    return bytes(out)


def encode_blocks(blocks: Sequence[bytes], level: int = 1, *, device,
                  mark=_no_mark, bucket=None):
    """Compress blocks into independent zstd frames on `device`: level <= 2
    the tile parse (G = 4), level >= 3 the exact parse. Returns (frames,
    dlens) for the RAP container. mark(stage) is called on the host at
    "start", after the upload ("h2d"), at the encoder's and both fetches'
    stage marks (the literal streams', then the sequence sections'), and
    after the host's frame assembly ("assemble"). bucket:
    lz4_device.upload_blocks'."""
    from . import compact
    # accel 2 is the tile grid G = 4 (0 when G * 4 > B), accel 1 the exact
    # parse: the JAX package's level rule
    arr, lens, B, G = lz.upload_blocks(blocks, 2 if level <= 2 else 1,
                                       device, mark, bucket)
    N = len(blocks)
    (litbuf, lit_sizes, nlits, lits, seqbuf, seq_size, nseq, wbuf, wsize,
     tab_ok, fse_use, fse_norms) = make_encoder(B, G)(arr, lens, mark=mark)
    SCAP = stream_cap(B)
    # fetch only the used bytes: streams and seq sections via the device
    # compactor; raw literals lazily (only fallback blocks need them)
    stream_chunks = compact.fetch_chunks(
        litbuf.reshape(N * 4, SCAP),
        ((lit_sizes.reshape(-1) + 7) // 8) * 8, mark=mark)
    seq_chunks = compact.fetch_chunks(seqbuf, ((seq_size + 7) // 8) * 8,
                                      mark=mark)
    meta = torch.cat([lit_sizes, nlits[:, None], seq_size[:, None],
                      nseq[:, None], wsize[:, None],
                      tab_ok[:, None].to(_I32), fse_use.to(_I32),
                      fse_norms.reshape(N, -1), wbuf.to(_I32)],
                     dim=1).cpu().numpy()

    frames = []
    for i, b in enumerate(blocks):
        row = meta[i]
        nl, ssz, ns, wsz, ok = (int(x) for x in row[4:9])
        streams = [stream_chunks[4 * i + k][:row[k]] for k in range(4)]
        tree = None
        if ok:
            blob = (bytes(ZF.WEIGHT_DESC)
                    + row[204:204 + wsz].astype(np.uint8).tobytes())
            if 1 < len(blob) < 128:
                tree = bytes([len(blob)]) + blob
        hdrs = (_seq_table_headers(row[9:12], row[12:204].reshape(3, 64))
                if ns > 0 else b"\x00")
        frames.append(_assemble_frame(
            b, nl, lambda i=i, nl=nl: lits[i, :nl].cpu().numpy().tobytes(),
            streams, ns, seq_chunks[i][:ssz], tree, seq_headers=hdrs))
    mark("assemble")
    return frames, [len(b) for b in blocks]
