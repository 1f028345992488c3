"""Raw-deflate decoder as a batched tensor pipeline (the device inflate
tier).

The port of aocl_compression_tpu/ops/inflate_device.py. The split:
  host   — the FIRST deflate block's header (csrc/deflate.cpp
           atpu_inflate_plan, through runtime/native.inflate_plan): the
           block type and the dynamic code lengths, turned into
           canonical-code parameters (_canon_params);
  device — 1. the interleaved literal/length/distance symbol scan, one
              lane per chunk, decoding each code by canonical-code
              arithmetic (a first-code/limit compare over the 15 code
              lengths, then a rank into the 288- or 32-entry symbol
              permutation), up to the block's end-of-block symbol;
           2. the compaction of the scan's (kind, val, dist) slots into the
              literal buffer and the (ll, ml, off) sequence list;
           3. LZ77 execution (zstd_decode_device._execute: fills and the
              src = src[src] resolve).
Steps 1 and 2 are one hand kernel on a CUDA tensor (csrc/inflate_scan.cu,
ops/inflate_scan.py): the scan meets literals and matches in slot order,
so it writes step 2's outputs directly. On a CPU tensor they are the plain
loop _symbol_scan_plain and _compact_plain.

The scan stops at the first block's end-of-block symbol: a multi-block
chunk regenerates fewer bytes than the container's dlen, and the caller
decodes it on the host, as it does a chunk the planner rejects (a stored
or corrupt first block). Sync-flush trailers are never reached. A corrupt
chunk gives garbage or a short decode here; the dlen gate and the stream's
adler32 catch it.

Every function returns what the JAX function returns for each lane; the
JAX package's uint32 words are int64 holding the 32-bit pattern. The JAX
_compact sorts with an unstable lax.sort, so the literal buffer past
litregen is unspecified there; here it is 0.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..runtime import native
from .compact import _no_mark
from .lz4_device import _I32, MAX_DEVICE_BLOCK, _bucket
from .zstd_decode_device import _bytes_to_words, _execute, _lane_take

# Slots the JAX package's scan adds past the B literals a lane can emit
# (its unroll); kept so both size MAXS = B + 4 alike.
_SCAN_PAD = 4

# RFC 1951 §3.2.5 length/distance code tables (format constants)
_LEN_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
             51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
_LEN_XBITS = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
              4, 4, 4, 5, 5, 5, 5, 0]
_DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
              385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
              16385, 24577, 1, 1]
_DIST_XBITS = [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9,
               9, 10, 10, 11, 11, 12, 12, 13, 13, 0, 0]
_MASK32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=4)
def _consts(device) -> dict:
    return {k: torch.tensor(v, dtype=torch.int64, device=device)
            for k, v in (("len_base", _LEN_BASE), ("len_xbits", _LEN_XBITS),
                         ("dist_base", _DIST_BASE),
                         ("dist_xbits", _DIST_XBITS),
                         ("ls", list(range(1, 16))))}


def _read_fwd(words, pos, nbits):
    """Forward LSB-first bitstream read of each lane: bits [pos, pos+nbits)
    of the int64-held uint32 words (N, W), word indices clamped to W-1;
    nbits (at most 16) an int or a per-lane tensor. Returns (value,
    pos + nbits), int64."""
    W = words.shape[1]
    wi = pos >> 5
    sh = pos & 31
    w0 = _lane_take(words, torch.clamp(wi, max=W - 1))
    w1 = _lane_take(words, torch.clamp(wi + 1, max=W - 1))
    v = (w0 >> sh) | torch.where(sh == 0, 0, (w1 << (32 - sh)) & _MASK32)
    nb = torch.as_tensor(nbits, dtype=torch.int64, device=words.device)
    return v & ((torch.ones_like(nb) << nb) - 1), pos + nb


def _bitrev15(v):
    """Reverse the low 15 bits (swizzle-mask reverse of 16, then >> 1)."""
    v = ((v & 0x5555) << 1) | ((v >> 1) & 0x5555)
    v = ((v & 0x3333) << 2) | ((v >> 2) & 0x3333)
    v = ((v & 0x0F0F) << 4) | ((v >> 4) & 0x0F0F)
    v = ((v & 0x00FF) << 8) | ((v >> 8) & 0x00FF)
    return v >> 1


def _huff_step(peek, fc, lim, rkb, perm):
    """Decode one canonical code of each lane from its 15-bit peek window:
    fc / lim / rkb (N, 16), perm (N, cap). Deflate packs code bits
    MSB-first into the LSB-first stream, so the l-bit code prefix is
    bitrev(peek) >> (15 - l); the first length whose first-code/limit pair
    holds it is the code's length. The JAX package takes perm flattened
    with a per-lane base; perm[lane, clip(rank, 0, cap - 1)] is the same
    element. Returns (sym, nbits); nbits == 0 marks an invalid code (the
    rank is then taken at length 1, as argmax of no hit gives 0)."""
    rev = _bitrev15(peek)
    code = rev[:, None] >> (15 - _consts(peek.device)["ls"])[None, :]
    ok = (code >= fc[:, 1:]) & (code < lim[:, 1:])
    li = torch.argmax(ok.to(_I32), dim=1)   # first (shortest-length) hit
    ln = torch.where(ok.any(dim=1), 1 + li, 0)
    rank = torch.gather(rkb[:, 1:] + code - fc[:, 1:], 1, li[:, None])[:, 0]
    sym = torch.gather(perm, 1, torch.clamp(rank, 0, perm.shape[1] - 1)
                       .to(torch.int64)[:, None])[:, 0]
    return sym.to(torch.int64), ln


# Root-table widths of the kernel (csrc/inflate_scan.cu kRootL, kRootD)
ROOT_BITS_L = 11
ROOT_BITS_D = 9


def _walk(peek, fc, lim, rkb, perm, lo: int, hi: int):
    """_huff_step's length walk restricted to lengths lo..hi, on 15-bit
    peeks (N, K) with each lane's parameters (N, 16) and perm (N, cap):
    (sym, nbits), each (N, K) int64, nbits = 0 where no length in lo..hi
    holds the peek's prefix (sym is then perm[lane, 0])."""
    N, K = peek.shape
    if lo > hi:
        z = torch.zeros((N, K), dtype=torch.int64, device=peek.device)
        return z, z
    ls = torch.arange(lo, hi + 1, device=peek.device)
    code = _bitrev15(peek)[:, :, None] >> (15 - ls)
    f = fc[:, None, lo:hi + 1].to(torch.int64)
    ok = (code >= f) & (code < lim[:, None, lo:hi + 1])
    li = torch.argmax(ok.to(_I32), dim=2, keepdim=True)
    nbits = torch.where(ok.any(dim=2), lo + li[..., 0], 0)
    rank = torch.gather(rkb[:, None, lo:hi + 1] + code - f, 2, li)[..., 0]
    rank = torch.where(nbits > 0, rank, 0)
    sym = torch.gather(perm.to(torch.int64), 1,
                       torch.clamp(rank, 0, perm.shape[1] - 1))
    return sym, nbits


def root_tables(fc, lim, rkb, perm, R: int):
    """The kernel's root decode table of R bits for each lane, in plain
    PyTorch (only the tests use it): (sym, nbits), each (N, 2^R) int64.
    Entry i is _huff_step's walk over lengths 1..R on the peek i; nbits = 0
    marks a "long" entry, where no length <= R holds the prefix. For l <= R
    the l-bit prefix of any peek lies in its low R bits, so the entry is
    the walk's answer for every peek with those low bits, whatever the
    parameters."""
    peeks = torch.arange(1 << R, device=fc.device).expand(fc.shape[0], -1)
    return _walk(peeks, fc, lim, rkb, perm, 1, R)


def root_decode(peek, fc, lim, rkb, perm, R: int, tables):
    """Decode 15-bit peeks (N, K) as the kernel does: the root entry of each
    peek's low R bits, and where it is long the walk over lengths R+1..15 on
    the whole peek. Returns (sym, nbits) as _huff_step does (nbits = 0: a
    bad code, whose sym the kernel never uses)."""
    t_sym, t_nb = tables
    low = peek & ((1 << R) - 1)
    sym, nbits = torch.gather(t_sym, 1, low), torch.gather(t_nb, 1, low)
    l_sym, l_nb = _walk(peek, fc, lim, rkb, perm, R + 1, 15)
    is_long = nbits == 0
    return (torch.where(is_long, l_sym, sym),
            torch.where(is_long, l_nb, nbits))


def _symbol_scan_plain(words, bitoff, fcL, limL, rkbL, permL, fcD, limD,
                       rkbD, permD, MAXS: int):
    """The interleaved literal/length/distance scan of every lane, one step
    of tensor ops per slot. Returns (kind, val, dist), each (N, MAXS)
    int32: kind 0 = nothing (done or corrupt), 1 = literal (val = byte),
    2 = match (val = length, dist). A bad code (none of the lengths holds
    it; a match with no distance code, or a distance symbol >= 30) writes
    (0, 0, 1), keeps the lane's position and ends the lane. Length symbols
    286 and 287 decode as length 258 with no extra bits, as in the JAX
    package. The loop stops once every lane is done: the JAX scan's
    remaining slots are (0, 0, 1)."""
    N = words.shape[0]
    dev = words.device
    c = _consts(dev)
    pos = bitoff.to(torch.int64)
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    kind = torch.zeros((N, MAXS), dtype=_I32, device=dev)
    val = torch.zeros_like(kind)
    dist = torch.ones_like(kind)
    for s in range(MAXS if N else 0):
        if bool(done.all()):
            break
        peek, _ = _read_fwd(words, pos, 15)
        sym, ln = _huff_step(peek, fcL, limL, rkbL, permL)
        bad = ln == 0
        pos_l = pos + ln
        is_eob = sym == 256
        is_lit = sym < 256
        # length extra bits (decoded unconditionally; pos only advances
        # down the branch actually taken)
        lc = torch.clamp(sym - 257, 0, 28)
        xv, pos_x = _read_fwd(words, pos_l, c["len_xbits"][lc])
        mlen = c["len_base"][lc] + xv
        # distance code + extra bits
        dpeek, _ = _read_fwd(words, pos_x, 15)
        dsym, dln = _huff_step(dpeek, fcD, limD, rkbD, permD)
        bad = bad | ((sym > 256) & ((dln == 0) | (dsym >= 30)))
        dc = torch.clamp(dsym, 0, 29)
        dxv, pos_d = _read_fwd(words, pos_x + dln, c["dist_xbits"][dc])
        dd = c["dist_base"][dc] + dxv

        live = ~done & ~bad
        k = torch.where(live & is_lit, 1, torch.where(live & (sym > 256), 2,
                                                      0))
        kind[:, s] = k.to(_I32)
        val[:, s] = torch.where(k == 1, sym,
                                torch.where(k == 2, mlen, 0)).to(_I32)
        dist[:, s] = torch.where(k == 2, dd, 1).to(_I32)
        pos = torch.where(live, torch.where(is_lit | is_eob, pos_l,
                                            pos_d), pos)
        done = done | bad | is_eob
    return kind, val, dist


def _compact_plain(kind, val, dist, B: int, MAXSEQ: int):
    """Per-lane compaction of scan slots (N, MAXS) into _execute's inputs:
    litbuf (N, B) uint8, the first B literal bytes in slot order (0 past
    litregen, where the JAX package's unstable sort leaves values
    unspecified); ll / ml / off (N, MAXSEQ) int32, the first MAXSEQ
    matches in slot order with ll = the literals since the previous match,
    off clipped to [1, B], and (0, 0, 1) past nbseq; nbseq and litregen
    (N,) int32, the match and literal counts (not capped). The JAX
    package's two sorts by slot are exclusive-cumsum scatters here."""
    N = kind.shape[0]
    dev = kind.device
    is_lit = (kind == 1).to(torch.int64)
    is_m = (kind == 2).to(torch.int64)
    nlit_excl = torch.cumsum(is_lit, 1) - is_lit
    nseq_excl = torch.cumsum(is_m, 1) - is_m

    # the spare column B (MAXSEQ) takes every slot that is not kept
    lidx = torch.where((is_lit > 0) & (nlit_excl < B), nlit_excl, B)
    litbuf = torch.zeros((N, B + 1), dtype=torch.uint8, device=dev)
    litbuf.scatter_(1, lidx, val.to(torch.uint8))
    sidx = torch.where((is_m > 0) & (nseq_excl < MAXSEQ), nseq_excl, MAXSEQ)

    def by_seq(x):
        out = torch.zeros((N, MAXSEQ + 1), dtype=torch.int64, device=dev)
        return out.scatter_(1, sidx, x.to(torch.int64))[:, :MAXSEQ]

    ml_c, off_c, lb_c = by_seq(val), by_seq(dist), by_seq(nlit_excl)
    nbseq = is_m.sum(1)
    prev_lb = torch.cat([torch.zeros_like(lb_c[:, :1]), lb_c[:, :-1]], 1)
    real = torch.arange(MAXSEQ, device=dev)[None, :] < nbseq[:, None]
    ll = torch.where(real, lb_c - prev_lb, 0).to(_I32)
    ml = torch.where(real, ml_c, 0).to(_I32)
    off = torch.where(real, torch.clamp(off_c, 1, B), 1).to(_I32)
    return (litbuf[:, :B], ll, ml, off, nbseq.to(_I32),
            is_lit.sum(1).to(_I32))


def _scan_compact(cbytes, bitoff, fcL, limL, rkbL, permL, fcD, limD, rkbD,
                  permD, B: int, MAXSEQ: int):
    """The symbol scan and the compaction of every lane: (litbuf, ll, ml,
    off, nbseq, litregen) as _compact_plain returns them. A CUDA tensor
    runs the kernel inflate_symbol_scan, a CPU tensor the plain versions
    (_compact_plain of _symbol_scan_plain at MAXS = B + 4)."""
    if cbytes.is_cuda:
        from . import inflate_scan
        return inflate_scan.inflate_symbol_scan(
            cbytes, bitoff, fcL, limL, rkbL, permL, fcD, limD, rkbD, permD,
            B, MAXSEQ)
    if cbytes.device.type == "cpu":
        slots = _symbol_scan_plain(_bytes_to_words(cbytes), bitoff, fcL,
                                   limL, rkbL, permL, fcD, limD, rkbD, permD,
                                   B + _SCAN_PAD)
        return _compact_plain(*slots, B, MAXSEQ)
    raise ValueError(f"inflate symbol scan: unsupported device "
                     f"{cbytes.device}")


def make_decoder(B: int, C: int):
    """Batched raw-deflate decoder over planned chunks.

    Inputs (N = batch), on one device:
      cbytes u8 (N, C)   chunk bytes (C % 4 == 0, zero-padded)
      bitoff i32 (N,)    symbol-section bit offset (from the planner)
      fc/lim/rkb i32 (N, 16) + perm i32 (N, 288|32): the canonical-code
      parameters of the litlen and distance alphabets.
    Returns (out u8 (N, B), dlen i32 (N,)): dlen is what the first deflate
    block regenerated; callers compare it with the expected chunk dlen.
    mark(stage) is called after "symbol_scan" and at _execute's stages.
    """
    MAXSEQ = B // 3 + 2

    def decode(cbytes, bitoff, fcL, limL, rkbL, permL, fcD, limD, rkbD,
               permD, mark=_no_mark):
        litbuf, ll, ml, off, nbseq, litregen = _scan_compact(
            cbytes, bitoff, fcL, limL, rkbL, permL, fcD, limD, rkbD, permD,
            B, MAXSEQ)
        mark("symbol_scan")
        return _execute(litbuf, ll, ml, off, nbseq, litregen, B, mark)

    return decode


# --- host orchestration ----------------------------------------------------------

def _canon_params(lens: np.ndarray, nsym: int):
    """Canonical-code arithmetic parameters from code lengths (numpy):
    first_code/limit per length, rank base, and the (len, sym)-ordered
    symbol permutation."""
    bl = np.bincount(lens, minlength=16)[:16]
    bl[0] = 0
    fc = np.zeros(16, np.int32)
    lim = np.zeros(16, np.int32)
    rkb = np.zeros(16, np.int32)
    code = 0
    rank = 0
    for b in range(1, 16):
        code = (code + int(bl[b - 1])) << 1
        fc[b] = code
        lim[b] = code + int(bl[b])
        rkb[b] = rank
        rank += int(bl[b])
    perm = np.zeros(nsym, np.int32)
    k = 0
    for b in range(1, 16):
        syms = np.nonzero(lens == b)[0]
        perm[k:k + len(syms)] = syms
        k += len(syms)
    return fc, lim, rkb, perm


def plan_chunks(chunks: Sequence[bytes]):
    """Run the C++ planner over chunks. Returns (ok mask, bitoffs, and the
    stacked canonical params (fcL, limL, rkbL, permL, fcD, limD, rkbD,
    permD)); chunks that are not ok go to the host."""
    N = len(chunks)
    ok = np.zeros(N, bool)
    bitoffs = np.zeros(N, np.int32)
    params = [np.zeros((N, w), np.int32) for w in (16, 16, 16, 288,
                                                   16, 16, 16, 32)]
    for i, c in enumerate(chunks):
        plan = native.inflate_plan(c)
        if plan is None:
            continue  # stored-first or corrupt: host tier
        ok[i] = True
        bitoffs[i], ll, dl = plan
        for p, v in zip(params[:4], _canon_params(ll, 288)):
            p[i] = v
        if dl.any():
            for p, v in zip(params[4:], _canon_params(dl, 32)):
                p[i] = v
    return ok, bitoffs, tuple(params)


def _groups(idx, dlens: Sequence[int], mem_limit: Optional[int]):
    """Split the chunk indices idx into device batches of <= mem_limit
    output bytes (one batch when mem_limit is unset)."""
    if not mem_limit:
        return [list(idx)]
    groups, cur, size = [], [], 0
    for i in idx:
        if cur and size + dlens[i] > mem_limit:
            groups.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += dlens[i]
    if cur:
        groups.append(cur)
    return groups


def decode_chunks(chunks: List[bytes], dlens: List[int], *, device,
                  host_one: Callable[[bytes, int], bytes],
                  mem_limit: Optional[int] = None,
                  mark=_no_mark) -> List[bytes]:
    """Decode raw-deflate chunk regions on `device`, one batch per group
    of <= mem_limit output bytes. Chunks the planner rejects, and chunks
    whose first block regenerated another size than the container
    recorded (multi-block, or corrupt), decode through host_one(chunk,
    dlen). mark(stage) is called at "start", after the host's plans
    ("plan"), per batch after its upload ("h2d_batch"), at the decoder's
    and the fetch's stage marks, and after the host route ("host")."""
    from . import compact
    if not chunks:
        return []
    if max(dlens) > MAX_DEVICE_BLOCK:
        raise ValueError(
            "device inflate: block exceeds the 64 KiB device limit "
            "(16-bit offset packing); use the host tier")
    mark("start")
    ok, bitoffs, params = plan_chunks(chunks)
    mark("plan")
    out: List[Optional[bytes]] = [None] * len(chunks)
    idx = np.nonzero(ok)[0]
    if len(idx):
        C = _bucket(max(len(chunks[i]) for i in idx))
        B = _bucket(max(max(dlens[i] for i in idx), 256))
        dec = make_decoder(B, C)
        for sel in _groups(idx, dlens, mem_limit):
            arr = np.zeros((len(sel), C), np.uint8)
            for k, i in enumerate(sel):
                arr[k, :len(chunks[i])] = np.frombuffer(chunks[i], np.uint8)
            args = [torch.from_numpy(a).to(device)
                    for a in (arr, bitoffs[sel], *[p[sel] for p in params])]
            mark("h2d_batch")
            res, dlen = dec(*args, mark=mark)
            dl = dlen.cpu().tolist()
            if B % compact.ROWB == 0:
                got = compact.fetch_chunks(res, torch.clamp(dlen, 0, B),
                                           mark=mark)
            else:
                rows = res.cpu().numpy()
                got = [rows[k, :max(0, min(d, B))].tobytes()
                       for k, d in enumerate(dl)]
            for k, i in enumerate(sel):
                if dl[k] == dlens[i]:
                    out[i] = got[k]
    for i, o in enumerate(out):
        if o is None:  # planner reject / multi-block / corrupt-short
            out[i] = host_one(chunks[i], dlens[i])
    mark("host")
    return out
