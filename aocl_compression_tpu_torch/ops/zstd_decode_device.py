"""zstd decoder as a batched tensor pipeline (the device decode tier).

The port of aocl_compression_tpu/ops/zstd_decode_device.py. The split:
  host   — header cracking and decode-table construction
           (csrc/zstd_decode.cpp atpu_zstd_frame_plan, through
           runtime/native.zstd_frame_plan);
  device — 1. Huffman literal decode, one lane per stream (4 per block);
           2. FSE sequence decode, one lane per block, with the
              repeat-offset update;
           3. LZ77 execution: monotone fills map every output byte to its
              sequence, and the back-references resolve by src = src[src]
              (the LZ4 decoder's _resolve).
The two scans are serial per lane: on a CUDA tensor each is a hand kernel
of csrc/zstd_scan.cu (ops/zstd_scan.py), on a CPU tensor a plain loop of
tensor ops over the lanes, one step per slot.

Scope (anything else decodes on the host, through the host-decode
callable the codec passes in): single-block frames whose content fits 64
KiB, which is what the RAP container of this package emits. A corrupt
stream gives garbage rather than an error here; the size check catches it.

Every function returns what the JAX function returns for each block; the
JAX package's uint32 words are int64 holding the 32-bit pattern, and its
int32 packs in the fills are the LZ4 decoder's int64 fills.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..codecs import zstd_format as ZF
from ..runtime import native
from . import lz4_device as lz
from .compact import _no_mark
from .deflate_device import _floor_log2
from .lz4_device import _I32, _NEG, MAX_DEVICE_BLOCK, _arange, _bucket

# --- plan layout (csrc/zstd_decode.cpp PM_* enum) ------------------------------
(PM_BTYPE, PM_BOFF, PM_BSIZE, PM_LITTYPE, PM_LITREGEN, PM_RLEBYTE,
 PM_NSTREAMS, PM_S0OFF, PM_S0LEN, PM_S1OFF, PM_S1LEN, PM_S2OFF, PM_S2LEN,
 PM_S3OFF, PM_S3LEN, PM_NBSEQ, PM_SEQOFF, PM_SEQLEN, PM_HUFLOG, PM_LLLOG,
 PM_OFLOG, PM_MLLOG, PLAN_STRIDE) = range(23)

HUF_SIZE = 1 << 11
FSE_SIZE = 1 << 9
_MASK32 = 0xFFFFFFFF
# Slots the JAX package's scans add past a batch's largest count (its
# unroll); kept in the scan-length buckets so both size MAXL alike.
_SCAN_PAD = 8
# Frames per device batch: bounds the (N, 64 KiB) working set of a call.
MAX_BATCH = 512


@functools.lru_cache(maxsize=4)
def _consts(device) -> dict:
    return {k: torch.tensor(v, dtype=torch.int64, device=device)
            for k, v in (("ll_base", ZF.LL_BASE), ("ll_bits", ZF.LL_BITS),
                         ("ml_base", ZF.ML_BASE), ("ml_bits", ZF.ML_BITS))}


def _lane_take(arr2d, idx):
    """arr2d[(lane, idx[lane])] — per-lane dynamic fetch (idx in range)."""
    return torch.gather(arr2d, 1, idx.long()[:, None])[:, 0]


def _read_back(words, pos, nbits):
    """Backward-bitstream read of each lane: bits [pos - nbits, pos) of the
    int64-held uint32 words (L, W), zero-filled below bit 0, as the int32
    the JAX package returns. Returns (value, pos - nbits), int64."""
    W = words.shape[1]
    bp = pos - nbits
    pre = torch.clamp(-bp, 0, 31)
    bpc = torch.clamp(bp, min=0)
    wi = bpc >> 5
    sh = bpc & 31
    w0 = torch.where(wi < W, _lane_take(words, torch.clamp(wi, max=W - 1)),
                     0xFFFFFFFF)   # take_along_axis past the end of
                                   # uint32 words: UINT_MAX
    w1 = torch.where(wi + 1 < W,
                     _lane_take(words, torch.clamp(wi + 1, max=W - 1)), 0)
    v = (w0 >> sh) | torch.where(sh == 0, 0, (w1 << (32 - sh)) & _MASK32)
    v = (v << pre) & _MASK32
    nbits = torch.as_tensor(nbits, device=words.device)
    mask = torch.where((nbits >= 0) & (nbits < 32),
                       (1 << torch.clamp(nbits, 0, 31).to(torch.int64)) - 1,
                       _MASK32)
    v = torch.where(pre >= nbits, 0, v & mask)
    v = torch.where(v >= 1 << 31, v - (1 << 32), v)
    return torch.where(nbits > 0, v, 0), bp


def _bytes_to_words(b_u8):
    """(..., 4k) uint8 -> (..., k) little-endian uint32 words, held in
    int64."""
    b = b_u8.to(torch.int64).reshape(*b_u8.shape[:-1], -1, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _init_pos(sbytes, slen):
    """Backward-reader start: (len-1)*8 + highbit(last byte); 0 for an
    empty lane."""
    li = torch.clamp(slen.to(torch.int64) - 1, min=0)
    last = torch.where(li < sbytes.shape[1],
                       _lane_take(sbytes.to(torch.int64),
                                  torch.clamp(li, max=sbytes.shape[1] - 1)),
                       1)
    hb = _floor_log2(torch.clamp(last, min=1), 8)
    return torch.where(slen > 0, (slen.to(torch.int64) - 1) * 8 + hb, 0)


def _literal_scan(sbytes, slens, counts, huftab, huflog, MAXL: int):
    """Decode the Huffman literal symbols of L = 4N stream lanes: sbytes
    (L, SB) uint8, slens / counts / huflog (L,) int32, huftab (N, 2048)
    int32 entries sym << 4 | nbits. Returns (L, MAXL) uint8, decoded at
    every slot below counts[lane] (the rest is not defined). A CUDA tensor
    runs the kernel huf_literal_scan, a CPU tensor the plain loop."""
    if sbytes.is_cuda:
        from . import zstd_scan
        return zstd_scan.huf_literal_scan(sbytes, slens, counts, huftab,
                                          huflog, MAXL)
    if sbytes.device.type == "cpu":
        return _literal_scan_plain(sbytes, slens, counts, huftab, huflog,
                                   MAXL)
    raise ValueError(f"_literal_scan: unsupported device {sbytes.device}")


def _literal_scan_plain(sbytes, slens, counts, huftab, huflog, MAXL: int):
    """PyTorch version of huf_literal_scan: one step of tensor ops per slot
    over all lanes, to the largest count; later slots are 0."""
    L = sbytes.shape[0]
    words = _bytes_to_words(sbytes)
    pos = _init_pos(sbytes, slens)
    hflat = huftab.reshape(-1).to(torch.int64)
    base = (torch.arange(L, device=sbytes.device) // 4) * HUF_SIZE
    out = torch.zeros((L, MAXL), dtype=torch.uint8, device=sbytes.device)
    for k in range(min(MAXL, int(counts.max()) if L else 0)):
        v, _ = _read_back(words, pos, huflog)
        entry = hflat[torch.clamp(base + v, 0, hflat.numel() - 1)]
        out[:, k] = (entry >> 4).to(torch.uint8)
        pos = pos - (entry & 15)
    return out


def _sequence_scan(qbytes, qlens, nbseq, fsetab, lllog, oflog, mllog,
                   MAXSEQ: int):
    """Decode the interleaved FSE sequence bitstream of each block lane:
    qbytes (N, QB) uint8, qlens / nbseq / the logs (N,) int32, fsetab (N, 3,
    512) int32 for [ll, of, ml]. Returns (ll, ml, offset), each (N, MAXSEQ)
    int32 in block order, (0, 0, 1) past nbseq. A CUDA tensor runs the
    kernel fse_sequence_scan, a CPU tensor the plain loop."""
    if qbytes.is_cuda:
        from . import zstd_scan
        logs = torch.stack([lllog, oflog, mllog], dim=1).to(_I32)
        return zstd_scan.fse_sequence_scan(qbytes, qlens, nbseq, fsetab,
                                           logs.contiguous(), MAXSEQ)
    if qbytes.device.type == "cpu":
        return _sequence_scan_plain(qbytes, qlens, nbseq, fsetab, lllog,
                                    oflog, mllog, MAXSEQ)
    raise ValueError(f"_sequence_scan: unsupported device {qbytes.device}")


def _sequence_scan_plain(qbytes, qlens, nbseq, fsetab, lllog, oflog, mllog,
                         MAXSEQ: int):
    """PyTorch version of fse_sequence_scan: one step of tensor ops per
    sequence over all lanes, to the largest nbseq."""
    N = qbytes.shape[0]
    dev = qbytes.device
    c = _consts(dev)
    words = _bytes_to_words(qbytes)
    pos = _init_pos(qbytes, qlens)
    flats = [fsetab[:, f].reshape(-1).to(torch.int64) for f in range(3)]
    bid = torch.arange(N, device=dev) * FSE_SIZE

    def entry(f, s):
        return flats[f][torch.clamp(bid + s, 0, N * FSE_SIZE - 1)]

    llS, pos = _read_back(words, pos, lllog)
    ofS, pos = _read_back(words, pos, oflog)
    mlS, pos = _read_back(words, pos, mllog)
    pos = torch.clamp(pos, min=0)
    r0 = torch.ones(N, dtype=torch.int64, device=dev)
    r1, r2 = 4 * r0, 8 * r0
    ll = torch.zeros((N, MAXSEQ), dtype=_I32, device=dev)
    ml = torch.zeros_like(ll)
    off = torch.ones_like(ll)
    for s in range(min(MAXSEQ, int(nbseq.max()) if N else 0)):
        active = s < nbseq
        le, oe, me = entry(0, llS), entry(1, ofS), entry(2, mlS)
        ofc = torch.clamp(oe & 0xFF, max=16)  # 64 KiB gate: ofc <= 16
        mlc = torch.clamp(me & 0xFF, max=52)
        llc = torch.clamp(le & 0xFF, max=35)
        # bit-read order of the host decoder: OF, ML, LL extras, then LL,
        # ML, OF state refills
        ofx, pos = _read_back(words, pos, ofc)
        mlx, pos = _read_back(words, pos, c["ml_bits"][mlc])
        llx, pos = _read_back(words, pos, c["ll_bits"][llc])
        ofv = (1 << ofc) + ofx
        mlv = c["ml_base"][mlc] + mlx
        llv = c["ll_base"][llc] + llx
        # rep-code resolution (zstd_decompress_block.c semantics)
        is_code = ofv > 3
        rep_idx = ofv - 1 + (llv == 0).to(torch.int64)
        off_rep = torch.where(rep_idx == 0, r0, torch.where(
            rep_idx == 1, r1, torch.where(rep_idx == 2, r2,
                                          torch.clamp(r0 - 1, min=1))))
        offset = torch.where(is_code, ofv - 3, off_rep)
        upd = active & (is_code | (rep_idx >= 1))
        r2 = torch.where(active & (is_code | (rep_idx >= 2)), r1, r2)
        r1 = torch.where(upd, r0, r1)
        r0 = torch.where(upd, offset, r0)
        lnb, pos = _read_back(words, pos, (le >> 8) & 0xFF)
        mnb, pos = _read_back(words, pos, (me >> 8) & 0xFF)
        onb, pos = _read_back(words, pos, (oe >> 8) & 0xFF)
        pos = torch.clamp(pos, min=0)
        llS = torch.where(active, (le >> 16) + lnb, llS)
        mlS = torch.where(active, (me >> 16) + mnb, mlS)
        ofS = torch.where(active, (oe >> 16) + onb, ofS)
        ll[:, s] = torch.where(active, llv, 0).to(_I32)
        ml[:, s] = torch.where(active, mlv, 0).to(_I32)
        off[:, s] = torch.where(active, offset, 1).to(_I32)
    return ll, ml, off


def _place_literals(syms, meta, scounts, rawlit, B: int):
    """The literal buffer (N, B) uint8 of each block: Huffman stream j of a
    4-stream block covers [j*q, j*q + count) with q = ceil(regen/4) (a
    1-stream block: [0, regen)), raw literals and the RLE byte otherwise.
    The JAX package scatters every live slot to its position; the streams
    are disjoint and inside [0, regen), so here every position gathers its
    slot."""
    N = meta.shape[0]
    dev = meta.device
    MAXL = syms.shape[1]
    regen = meta[:, PM_LITREGEN]
    q = torch.where(meta[:, PM_NSTREAMS] == 4, (regen + 3) >> 2, regen)
    p = _arange(B, dev)
    j = torch.clamp(torch.div(p, torch.clamp(q, min=1)[:, None],
                              rounding_mode="floor"), max=3)
    k = p - j * q[:, None]
    live = k < torch.gather(scounts, 1, j.long())
    slot = (torch.arange(N, device=dev)[:, None] * 4 + j) * MAXL \
        + torch.clamp(k, 0, MAXL - 1)
    lit = torch.where(live, syms.reshape(-1)[slot.long()], 0)
    littype = meta[:, PM_LITTYPE, None]
    return torch.where(littype == 2, lit, torch.where(
        littype == 1, meta[:, PM_RLEBYTE, None].to(torch.uint8), rawlit))


def _execute(litbuf, ll, ml, off, nbseq, litregen, B: int, mark=_no_mark):
    """LZ77 execution on the output domain of each block: monotone fills
    map each output byte to its covering sequence, and the back-reference
    chains resolve to literal roots. Returns (out (N, B) uint8, dlen (N,)).
    mark(stage) is called after "execute_fills", per resolve pass
    ("resolve_pass"), after "resolve" and "gather_output"."""
    N, MAXSEQ = ll.shape
    dev = ll.device
    i64 = torch.int64
    sid = _arange(MAXSEQ + 1, dev)
    nb = nbseq[:, None]
    # phantom sequence AT slot nbseq carries the trailing literals
    lit_sum = ll.sum(dim=1, dtype=_I32)
    zero = ll.new_zeros(N, 1)
    llp = torch.cat([ll, zero], dim=1)
    mlp = torch.cat([ml, zero], dim=1)
    offx = torch.cat([off, zero + 1], dim=1)
    real = sid <= nb
    llx = torch.where(sid < nb, llp,
                      torch.where(sid == nb, (litregen - lit_sum)[:, None], 0))
    mlx = torch.where(sid < nb, mlp, 0)
    prod = llx + mlx
    outstart = torch.cumsum(prod, dim=1, dtype=_I32) - prod
    litbase = torch.cumsum(llx, dim=1, dtype=_I32) - llx
    dlen = outstart[:, -1] + prod[:, -1]

    tstart = torch.where(real & (prod > 0), outstart, B)
    f_os = lz._fill(outstart, tstart, B, 0)
    f_lb = lz._fill(litbase, tstart, B, 0)
    f_ms = lz._fill(outstart + llx, tstart, B, 0)
    # offsets are not monotone: ride outstart's strictly-increasing high
    # bits through the cummax fill (int64 packs)
    f_off = (lz._fill(((outstart.to(i64) << 16)
                       | torch.clamp(offx, 1, 0xFFFF)) + _NEG,
                      tstart, B, _NEG) - _NEG) & 0xFFFF
    f_off = torch.clamp(f_off, min=1).to(_I32)

    o = _arange(B, dev)
    # an overlapping match (off < ml) is a periodic fill: every byte
    # sources directly from the first period
    src = torch.where(o < f_ms, -(f_lb + (o - f_os)) - 1,
                      (f_ms - f_off) + torch.remainder(o - f_ms, f_off))
    src = torch.where(o < dlen[:, None], src, -1)
    src = torch.where(src >= o, -1, src)  # corrupt-stream self-loop guard
    mark("execute_fills")
    src, _ = lz._resolve(src, mark)
    mark("resolve")
    out = torch.gather(litbuf, 1, torch.clamp(-src - 1, 0, B - 1).to(i64))
    out = torch.where(o < dlen[:, None], out, 0)
    mark("gather_output")
    return out, dlen


def make_decoder(B: int, SB: int, QB: int, MAXL: int = 0, MAXSEQ: int = 0):
    """Batched decoder over planned compressed blocks.

    MAXL / MAXSEQ: the literal-slot and sequence widths of the scans'
    outputs, bucketed by the batch's largest counts (decode_frames sizes
    them); 0 = the worst case.

    Inputs (N = batch), on one device:
      meta    i32 (N, PLAN_STRIDE)
      huftab  i32 (N, HUF_SIZE)
      fsetab  i32 (N, 3, FSE_SIZE)
      sbytes  u8  (N, 4, SB)   literal stream bytes (left-justified)
      slens   i32 (N, 4)
      scounts i32 (N, 4)       symbols per stream
      qbytes  u8  (N, QB)      sequence bitstream bytes
      rawlit  u8  (N, B)       raw literals
    Returns (out u8 (N, B), dlen i32 (N,)). mark(stage) is called after
    "literal_scan", "literal_place", "sequence_scan" and _execute's
    stages.
    """
    if not MAXL:
        MAXL = max(B // 4 + _SCAN_PAD, 1024)
    if not MAXSEQ:
        MAXSEQ = B // 3 + 2

    def decode(meta, huftab, fsetab, sbytes, slens, scounts, qbytes, rawlit,
               mark=_no_mark):
        N = meta.shape[0]
        L = 4 * N
        hlog = meta[:, PM_HUFLOG].repeat_interleave(4).contiguous()
        syms = _literal_scan(sbytes.reshape(L, SB), slens.reshape(L),
                             scounts.reshape(L), huftab, hlog, MAXL)
        mark("literal_scan")
        litbuf = _place_literals(syms, meta, scounts, rawlit, B)
        mark("literal_place")
        nbseq = meta[:, PM_NBSEQ].contiguous()
        ll, ml, off = _sequence_scan(
            qbytes, meta[:, PM_SEQLEN].contiguous(), nbseq, fsetab,
            meta[:, PM_LLLOG], meta[:, PM_OFLOG], meta[:, PM_MLLOG], MAXSEQ)
        mark("sequence_scan")
        return _execute(litbuf, ll, ml, off, nbseq, meta[:, PM_LITREGEN], B,
                        mark)

    return decode


# --- host orchestration ----------------------------------------------------------

class _FramePlan:
    __slots__ = ("start", "csize", "kind", "block", "content")

    def __init__(self, start, csize, kind, block=None, content=None):
        self.start = start
        self.csize = csize
        self.kind = kind        # "device" | "host" | "skippable"
        self.block = block      # index into the device plans
        self.content = content  # host-decoded bytes (host kind)


def _stream_caps(B: int) -> Tuple[int, int]:
    return B // 4 + 4096, B  # SB, QB


def _plan_arrays(src: np.ndarray, metas, B: int):
    """The padded batch of planned blocks for make_decoder: (meta, sbytes,
    slens, scounts, qbytes, rawlit) numpy arrays, and the scan widths
    (MAXL, MAXSEQ) bucketed to the batch's largest counts."""
    SB, QB = _stream_caps(B)
    N = len(metas)
    meta = np.stack(metas)
    sbytes = np.zeros((N, 4, SB), np.uint8)
    slens = np.zeros((N, 4), np.int32)
    scounts = np.zeros((N, 4), np.int32)
    qbytes = np.zeros((N, QB), np.uint8)
    rawlit = np.zeros((N, B), np.uint8)
    for i, m in enumerate(metas):
        if m[PM_LITTYPE] == 2:
            regen = int(m[PM_LITREGEN])
            ns = int(m[PM_NSTREAMS])
            qq = (regen + 3) // 4 if ns == 4 else regen
            for j in range(ns):
                so, sl = int(m[PM_S0OFF + 2 * j]), int(m[PM_S0LEN + 2 * j])
                sbytes[i, j, :sl] = src[so:so + sl]
                slens[i, j] = sl
                scounts[i, j] = min(qq, regen - j * qq) if ns == 4 else regen
            if ns == 4:
                scounts[i, 3] = regen - 3 * qq
        elif m[PM_LITTYPE] == 0:
            so, sl = int(m[PM_S0OFF]), int(m[PM_S0LEN])
            rawlit[i, :sl] = src[so:so + sl]
        sq, ql = int(m[PM_SEQOFF]), int(m[PM_SEQLEN])
        if ql:
            qbytes[i, :ql] = src[sq:sq + ql]
    MAXL = min(_bucket(max(int(scounts.max()), 1) + _SCAN_PAD, 512),
               max(B // 4 + _SCAN_PAD, 1024))
    MAXSEQ = min(_bucket(int(meta[:, PM_NBSEQ].max()) + 2, 512), B // 3 + 2)
    return (meta, sbytes, slens, scounts, qbytes, rawlit), (MAXL, MAXSEQ)


def _decode_batch(src: np.ndarray, metas, hufs, fses, device,
                  mark) -> Tuple[List[bytes], List[int]]:
    """Decode one device batch of planned blocks: (outputs cut at
    min(dlen, B), dlens)."""
    from . import compact
    B = MAX_DEVICE_BLOCK
    (meta, sbytes, slens, scounts, qbytes, rawlit), widths = _plan_arrays(
        src, metas, B)

    def up(a, dtype=None):
        t = torch.from_numpy(a if dtype is None else a.astype(dtype))
        return t.to(device)

    args = (up(meta), up(np.stack(hufs), np.int32),
            up(np.stack(fses), np.int32), up(sbytes), up(slens),
            up(scounts), up(qbytes), up(rawlit))
    mark("h2d_batch")
    out, dlen = make_decoder(B, *_stream_caps(B), *widths)(*args, mark=mark)
    dl = dlen.cpu().tolist()
    return compact.fetch_chunks(out, torch.clamp(dlen, 0, B), mark=mark), dl


def decode_frames(data: bytes, expected_size: Optional[int] = None, *,
                  device, host_decode: Callable[[bytes], bytes],
                  mark=_no_mark) -> bytes:
    """Decode a stream of concatenated zstd frames on `device`, batching
    every single-block frame that fits the device gate; any other frame,
    and one whose unknown content size turns out larger than 64 KiB,
    decodes through host_decode(frame). Skippable frames are skipped.
    Raises ValueError on a corrupt header or when expected_size is given
    and not met. mark(stage) is called at "start", after the host's plans
    ("plan"), and per device batch after its upload ("h2d_batch"), at the
    decoder's and the fetch's stage marks."""
    B = MAX_DEVICE_BLOCK
    SB, QB = _stream_caps(B)
    src = np.frombuffer(data, dtype=np.uint8)
    frames: List[_FramePlan] = []
    metas, hufs, fses = [], [], []
    mark("start")
    off, n = 0, len(data)
    while off < n:
        # one block is all a device frame may hold: a longer frame plans
        # as nb == -1 and goes to the host
        res = native.zstd_frame_plan(data, off, max_blocks=1)
        if res is None:
            raise ValueError("zstd: corrupt frame header")
        nb, meta, huf, fse, consumed = res
        if nb == 0:
            frames.append(_FramePlan(off, consumed, "skippable"))
            off += consumed
            continue
        ok = nb == 1
        if ok:
            m0 = meta[0]
            # content size from the frame header when declared (this
            # package's encoder always writes it); an unknown size is
            # checked against the device's dlen instead
            fcs = native.zstd_frame_content_size(data[off:off + consumed])
            ok = (m0[PM_BTYPE] == 2
                  and (fcs is None or fcs <= B)
                  and m0[PM_LITREGEN] <= B
                  and all(m0[PM_S0LEN + 2 * i] <= SB for i in range(4))
                  and m0[PM_SEQLEN] <= QB
                  and m0[PM_NBSEQ] <= B // 3)
        if ok:
            frames.append(_FramePlan(off, consumed, "device",
                                     block=len(metas)))
            metas.append(m0)
            hufs.append(huf[0])
            fses.append(fse[0])
        else:
            frames.append(_FramePlan(off, consumed, "host", content=host_decode(
                data[off:off + consumed])))
        off += consumed
    mark("plan")

    outs, dlens = [], []
    for i in range(0, len(metas), MAX_BATCH):
        o, d = _decode_batch(src, metas[i:i + MAX_BATCH],
                             hufs[i:i + MAX_BATCH], fses[i:i + MAX_BATCH],
                             device, mark)
        outs.extend(o)
        dlens.extend(d)

    parts = []
    for f in frames:
        if f.kind == "device":
            if dlens[f.block] > B:
                # an unknown-content-size frame larger than the device's
                # output domain: decode it on the host
                parts.append(host_decode(data[f.start:f.start + f.csize]))
            else:
                parts.append(outs[f.block])
        elif f.kind == "host":
            parts.append(f.content)
    res = b"".join(parts)
    if expected_size is not None and len(res) != expected_size:
        raise ValueError(
            f"zstd device decode: size mismatch ({len(res)} != "
            f"{expected_size}) — corrupt stream")
    return res


def decode_chunks(chunks: List[bytes], dlens: List[int], *, device,
                  host_decode: Callable[[bytes], bytes],
                  mark=_no_mark) -> List[bytes]:
    """RAP adapter entry. Chunk regions concatenate into a valid frame
    stream (the container contract), so all chunks decode in one pass; the
    result re-splits at the known chunk output sizes."""
    blob = decode_frames(b"".join(chunks), expected_size=int(sum(dlens)),
                         device=device, host_decode=host_decode, mark=mark)
    outs, pos = [], 0
    for dl in dlens:
        outs.append(blob[pos:pos + dl])
        pos += dl
    return outs
