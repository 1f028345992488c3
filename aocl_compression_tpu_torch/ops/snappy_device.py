"""Snappy raw-format encoder and decoder as batched tensor pipelines (tier
TORCH).

The port of aocl_compression_tpu/ops/snappy_device.py. Match finding, the
parses, the fills and the chain marking are the LZ4 pipelines' (ops/
lz4_device.py); only the element serialization and the tag scan are
snappy's:

  literal elements: tag (len-1)<<2, +1/+2 extra length bytes above 60/256
  copy elements:    a match of length L splits like the reference's
                    EmitCopy: 64-byte 2-byte-offset copies while L >= 68,
                    one 60-byte copy if 64 < L <= 67, then a final copy in
                    the 2-byte tag form (1-byte offset, len 4-11, offset <
                    2048) when it qualifies, else the 3-byte form.

Each block encodes to a self-contained element stream without the
stream's varint preamble, so the container concatenates chunks as they
are; the codec writes the one preamble.

Encode: G >= 2 (accel >= 2) runs the sort-emit skeleton of the LZ4
encoder on the tile domain (_emit_snappy_sorted, rows of B bytes, the
trailing literal element appended on the host; on the card the kernel
emit_snappy, with no sort); G = 0 the exact greedy
parse and the fill + gather serializer (_emit_snappy, rows of
out_capacity(B) bytes, complete streams).

Decode: _tag_scan parses an element at every byte position; the LZ4
decoder's chain marking, output map, resolve loop and gather do the rest.

Every function takes a batch as (N, ...) tensors on one device and returns
what the JAX function returns for each block, bit for bit. The packed
(hi << 16 | lo) fill values, which wrap as int32 in the JAX package, are
int64 here: the same numbers without the wrap.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from . import lz4_device as lz
from .compact import _no_mark
from .lz4_device import (_BIGPOS, _DUMMY_POS, _I32, _NEG, MIN_MATCH,
                         _arange, _fill, _shl, _shr)


def out_capacity(block_size: int) -> int:
    """snappy MaxCompressedLength bound (snappy.cc:218), row-aligned."""
    n = 32 + block_size + block_size // 6
    return -(-n // 512) * 512


def _drop(idx: torch.Tensor, cap: int) -> torch.Tensor:
    """Scatter index with the JAX package's mode="drop": entries outside
    [0, cap) go to the spare slot `cap`, which the caller cuts off."""
    return torch.where((idx >= 0) & (idx < cap), idx, cap).to(torch.int64)


# =============================================================================
# Encoder
# =============================================================================

def _lit_hdr(lit):
    """Literal element header size: 0 (no element), 1, 2 or 3 bytes (the
    JAX package's _lit_hdr and _snappy_hdr)."""
    return torch.where(lit == 0, 0, torch.where(
        lit <= 60, 1, torch.where(lit <= 256, 2, 3))).to(_I32)


def _copy_fields(ml, off):
    """Reference EmitCopy splitting: (n64, has60, final_len, qualifies,
    ncopy, final op bytes, copy bytes) — the JAX package's _copy_split
    and _snappy_copy_fields, which agree (max(0, (ml - 4) // 64) is
    max(ml - 4, 0) >> 6)."""
    n64 = torch.clamp(ml - MIN_MATCH, min=0) >> 6
    l2 = ml - 64 * n64
    has60 = (l2 > 64).to(_I32)
    l3 = l2 - 60 * has60
    qual = (l3 < 12) & (off < 2048) & (l3 >= 4)
    ncopy = n64 + has60 + 1
    fin = torch.where(qual, 2, 3).to(_I32)
    return n64, has60, l3, qual, ncopy, fin, 3 * (ncopy - 1) + fin


def _emit_snappy(data_u8, pos, ml, off, nseq, n, B: int, OUTCAP: int,
                 MAXSEQ: int):
    """Serialize the selected sequences into complete snappy element
    streams, the trailing literal element written in place. Returns
    (out (N, OUTCAP) uint8, size (N,), tail literals (N,))."""
    dev = pos.device
    N = pos.shape[0]
    i64 = torch.int64
    real = _arange(MAXSEQ, dev) < nseq[:, None]

    ends = pos + ml
    lit_start = torch.where(real, _shr(ends, 1, 0), 0)
    lit = torch.where(real, pos - lit_start, 0)

    last = torch.clamp(nseq - 1, 0, MAXSEQ - 1).to(i64)[:, None]
    has = nseq > 0
    tail_start = torch.where(has, torch.gather(ends, 1, last)[:, 0], 0)
    tail = n.to(_I32) - tail_start

    seq_sz = torch.where(real, _seq_size(lit, ml, off)[0], 0)
    incl = torch.cumsum(seq_sz, dim=1, dtype=_I32)
    body = torch.where(has, torch.gather(incl, 1, last)[:, 0], 0)
    excl = incl - seq_sz

    # monotone fills: every output byte learns its sequence's fields
    starts = torch.where(real, excl, OUTCAP)
    f_excl = _fill(excl, starts, OUTCAP, 0)
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
    hdr_b = _lit_hdr(lit_b)
    n64_b, _, l3_b, qual_b, ncopy_b = _copy_fields(ml_b, off_b)[:5]

    # --- literal element ----------------------------------------------------
    lit_tag = torch.where(lit_b <= 60, (lit_b - 1) << 2,
                          torch.where(lit_b <= 256, 60 << 2, 61 << 2))
    lm1 = lit_b - 1
    lit_hdr_byte = torch.where(delta == 0, lit_tag,
                               torch.where(delta == 1, lm1 & 0xFF,
                                           (lm1 >> 8) & 0xFF))
    lit_byte_pos = torch.clamp(start_b + delta - hdr_b, 0, B - 1)
    lit_byte = torch.gather(data_u8, 1, lit_byte_pos.to(i64)).to(_I32)

    # --- copy elements ------------------------------------------------------
    rel = delta - hdr_b - lit_b
    c = rel // 3                       # floor: rel < 0 off the copy bytes
    r = rel - 3 * c
    is_final = c == (ncopy_b - 1)
    relf = rel - 3 * (ncopy_b - 1)     # offset within the final op
    # middle op length: 64 for c < n64, else 60 (the has60 op)
    mid_tag = torch.where(c < n64_b, 0x02 | (63 << 2), 0x02 | (59 << 2))
    fin_tag = torch.where(qual_b,
                          0x01 | ((l3_b - 4) << 2) | ((off_b >> 8) << 5),
                          0x02 | ((l3_b - 1) << 2))
    copy_byte = torch.where(
        is_final,
        torch.where(relf == 0, fin_tag,
                    torch.where(relf == 1, off_b & 0xFF, off_b >> 8)),
        torch.where(r == 0, mid_tag,
                    torch.where(r == 1, off_b & 0xFF, off_b >> 8)))

    byte = torch.where(delta < hdr_b, lit_hdr_byte,
                       torch.where(delta < hdr_b + lit_b, lit_byte,
                                   copy_byte))
    out = torch.zeros((N, OUTCAP + 1), dtype=_I32, device=dev)
    out[:, :OUTCAP] = torch.where(j < body[:, None], byte, 0)

    # --- trailing literal element, written in place -------------------------
    ht = _lit_hdr(tail)
    t1 = tail - 1
    tag_t = torch.where(tail <= 60, t1 << 2,
                        torch.where(tail <= 256, 60 << 2, 61 << 2))
    hdr_vals = torch.stack([tag_t, t1 & 0xFF, (t1 >> 8) & 0xFF], dim=1)
    k3 = _arange(3, dev)
    hdr_idx = torch.where(k3 < ht[:, None], body[:, None] + k3, OUTCAP)
    out.scatter_add_(1, _drop(hdr_idx, OUTCAP), hdr_vals.to(_I32))
    i = _arange(B, dev)
    ts = tail_start[:, None]
    in_tail = (i >= ts) & (i < n.to(_I32)[:, None]) & (tail[:, None] > 0)
    tpos = torch.where(in_tail, (body + ht)[:, None] + (i - ts), OUTCAP)
    out.scatter_add_(1, _drop(tpos, OUTCAP), data_u8.to(_I32))

    size = body + torch.where(tail > 0, ht + tail, 0)
    return out[:, :OUTCAP].to(torch.uint8), size, tail


def _seq_size(lit, ml, off):
    """(sequence bytes, header bytes: literal header + copy ops)."""
    hdr = _lit_hdr(lit)
    cb = _copy_fields(ml, off)[6]
    return hdr + cb + lit, hdr + cb


def _emit_snappy_sorted(data_u8, n, sel, cpos, cml, coff, B: int, G: int):
    """The snappy sort-emit serializer: (out (N, B) uint8, body (N,), tail
    literals (N,), flag (N,)), as _emit_snappy_sorted_plain defines them.

    A CUDA tensor runs the kernel emit_snappy (csrc/emit_sorted.cu: each
    output byte written at its rank among the row's output positions, no
    sort) and nothing else, a CPU tensor the plain version.
    """
    if data_u8.is_cuda:
        from . import emit_sorted as es
        return es.emit_snappy(data_u8.contiguous(), n.to(_I32).contiguous(),
                              sel, cpos, cml, coff, B, G)
    if data_u8.device.type == "cpu":
        return _emit_snappy_sorted_plain(data_u8, n, sel, cpos, cml, coff,
                                         B, G)
    raise ValueError(f"_emit_snappy_sorted: unsupported device "
                     f"{data_u8.device}")


def _emit_snappy_sorted_plain(data_u8, n, sel, cpos, cml, coff, B: int,
                              G: int):
    """Gather-free sort-emit serializer for the snappy element format (the
    snappy counterpart of lz4_device._emit_sorted): literal bytes carry
    their own input byte, matched "spare" positions carry the element
    header and copy-op bytes, one sort of (out_pos << 8 | byte)
    materializes the stream.

    Returns (out (N, B) uint8, body (N,), tail literals (N,), flag (N,));
    the caller appends the trailing literal element and re-encodes flagged
    blocks (a sequence whose headers need more bytes than its match has
    spares) on the host tier.
    """
    dev = data_u8.device
    N = data_u8.shape[0]
    i64 = torch.int64
    end_t = torch.where(sel, cpos + cml, 0)
    ce = torch.cummax(end_t, dim=1).values
    pe = _shr(ce, 1, 0)
    lit_t = torch.where(sel, cpos - pe, 0)
    ml_t = torch.where(sel, cml, 0)
    off_t = torch.where(sel, coff, 1)
    seq_sz_t, hdr_cost_t = _seq_size(lit_t, ml_t, off_t)
    seq_sz = torch.where(sel, seq_sz_t, 0)
    incl = torch.cumsum(seq_sz, dim=1, dtype=_I32)
    body = incl[:, -1]
    flag = torch.any(sel & (hdr_cost_t > ml_t), dim=1)
    tail = n.to(_I32) - ce[:, -1]

    # tile-domain monotone fills of the covering sequence's fields (F), its
    # predecessor's (P) and the next sequence's position (N); pos/off and
    # end-1/lit strictly increase over selected tiles
    packF1 = ((cpos.to(i64) << 16) | off_t) + _NEG
    packF2 = (((cpos + cml - 1).to(i64) << 16) | lit_t) + _NEG
    f1 = torch.cummax(torch.where(sel, packF1, _NEG), dim=1).values
    f2 = torch.cummax(torch.where(sel, packF2, _NEG), dim=1).values
    p1 = torch.cummax(torch.where(sel, _shr(f1, 1, _NEG), _NEG), dim=1).values
    p2 = torch.cummax(torch.where(sel, _shr(f2, 1, _NEG), _NEG), dim=1).values
    rn = lz._rev_cummin(torch.where(sel, cpos, _BIGPOS))
    rnx = _shl(rn, 1, _BIGPOS)

    def unpack(f):
        u = f - _NEG
        return (u >> 16).to(_I32), (u & 0xFFFF).to(_I32)

    # unpack on the tile domain, then broadcast to the G bytes of each tile
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
    useP = covered & (i < posF - litF)

    pos_x = torch.where(useP, posP, posF)
    off_x = torch.where(useP, offP, offF)
    lit_x = torch.where(useP, litP, litF)
    end_x = torch.where(useP, endP1 + 1, endF)
    ml_x = end_x - pos_x
    hdr_x = _lit_hdr(lit_x)
    n64_x, _, l3_x, qual_x, ncopy_x, _, cb_x = _copy_fields(ml_x, off_x)
    sz_x = hdr_x + cb_x + lit_x
    szF, _ = _seq_size(litF, endF - posF, offF)
    excl_x = torch.where(useP, b_incl - szF - sz_x, b_incl - sz_x)

    # N branch: literal bytes of the next sequence (or the tail -> dummy)
    litN = b_posN - endF
    hdrN = _lit_hdr(litN)
    opN = b_incl + hdrN + (i - endF)

    # covered: role by spare index k
    k = i - pos_x
    is_lit = covered & (k < 0)
    opL = excl_x + hdr_x + (i - (pos_x - lit_x))

    lm1 = lit_x - 1
    lit_tag = torch.where(lit_x <= 60, lm1 << 2,
                          torch.where(lit_x <= 256, 60 << 2, 61 << 2))
    v_hdr = torch.where(k == 0, lit_tag,
                        torch.where(k == 1, lm1 & 0xFF, (lm1 >> 8) & 0xFF))

    k2 = k - hdr_x
    base_cp = excl_x + hdr_x + lit_x
    # divide-by-3 by the JAX package's magic multiply on a clamped domain
    k2c = torch.clamp(k2, 0, 1023)
    jop = (k2c * 43691) >> 17
    r = k2c - 3 * jop
    in_mid = k2 < 3 * (ncopy_x - 1)
    mid_tag = torch.where(jop < n64_x, 0x02 | (63 << 2), 0x02 | (59 << 2))
    relf = k2 - 3 * (ncopy_x - 1)
    fin_tag = torch.where(qual_x,
                          0x01 | ((l3_x - 4) << 2) | ((off_x >> 8) << 5),
                          0x02 | ((l3_x - 1) << 2))
    v_cp = torch.where(
        in_mid,
        torch.where(r == 0, mid_tag,
                    torch.where(r == 1, off_x & 0xFF, off_x >> 8)),
        torch.where(relf == 0, fin_tag,
                    torch.where(relf == 1, off_x & 0xFF, off_x >> 8)))
    sp_dead = k2 >= cb_x
    op_sp = torch.where(k < hdr_x, excl_x + k, base_cp + k2)
    v_sp = torch.where(k < hdr_x, v_hdr, v_cp)

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


def _encode_block(data_u8, n, B: int, OUTCAP: int, MAXSEQ: int, G: int = 0,
                  mark=_no_mark):
    """The fill + gather encoder (exact greedy parse at G = 0, the
    compacted tile parse at G >= 1). mark(stage) is called on the host
    after each stage is enqueued ("find_matches", then "greedy_parse" and
    "select_sequences" or "grid_parse", then "emit")."""
    mlen, moff, valid = lz._find_matches(data_u8, n, B)
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
    res = _emit_snappy(data_u8, pos, ml, off, nseq, n, B, OUTCAP, MAXSEQ)
    mark("emit")
    return res


def _encode_block_v2(data_u8, n, B: int, G: int, depth: int = 4,
                     nw: int = 8, subm: int = 128, mark=_no_mark):
    """The tile path on the LZ4 sort-emit skeleton: shared matcher -> tile
    election and chain marking -> snappy sort-emit. match_cap = 4 + 4*nw
    (<= 64) keeps every copy single-op. mark(stage) is called on the host
    after "find_matches", "grid_select" and "emit_sorted"."""
    mlen, moff, valid = lz._find_matches(data_u8, n, B, depth=depth, nw=nw)
    mark("find_matches")
    sel, cpos, cml, coff = lz._grid_select(mlen, moff, valid, B, G,
                                           subm=subm, match_cap=4 + 4 * nw)
    mark("grid_select")
    res = _emit_snappy_sorted(data_u8, n, sel, cpos, cml, coff, B, G)
    mark("emit_sorted")
    return res


def make_encoder(block_size: int, G: int = 0):
    """The batched encoder.

    Signature: (blocks uint8[N, B], lens int32[N], mark=...) ->
               (bodies, body_sizes int32[N], tails int32[N], flags bool[N])
    on the device the inputs lie on. G >= 2: bodies uint8[N, B] without
    the trailing literal element, flags mark the blocks the sort-emit could
    not serialize. G < 2: bodies uint8[N, out_capacity(B)] are complete
    streams and flags all False.
    """
    B = block_size
    if G >= 2:
        def encode(blocks, lens, mark=_no_mark):
            return _encode_block_v2(blocks, lens, B=B, G=G, mark=mark)

        return encode
    OUTCAP = out_capacity(B)
    MAXSEQ = (B // max(G, MIN_MATCH)) + 2

    def encode0(blocks, lens, mark=_no_mark):
        out, size, tail = _encode_block(blocks, lens, B=B, OUTCAP=OUTCAP,
                                        MAXSEQ=MAXSEQ, G=G, mark=mark)
        return out, size, tail, torch.zeros_like(size, dtype=torch.bool)

    return encode0


def literal_element(lits: bytes) -> bytes:
    """Host-side literal element (the per-block tail)."""
    n = len(lits)
    if n == 0:
        return b""
    if n <= 60:
        return bytes([(n - 1) << 2]) + lits
    if n <= 256:
        return bytes([60 << 2, n - 1]) + lits
    return bytes([61 << 2, (n - 1) & 0xFF, (n - 1) >> 8]) + lits


def encode_blocks(blocks: Sequence[bytes], accel: int = 1, *, device,
                  mark=_no_mark, bucket=None):
    """Compress blocks on `device` into element streams without the
    stream's varint preamble. Returns (fragments, flagged): flagged lists
    the blocks the sort-emit encoder could not serialize, whose fragments
    are None; the codec tier re-encodes them on the host. mark(stage) is
    called on the host at "start", after the upload ("h2d"), and at the
    encoder's and the fetch's stage marks. bucket:
    lz4_device.upload_blocks'."""
    from . import compact
    arr_d, lens_d, B, G = lz.upload_blocks(blocks, accel, device, mark,
                                           bucket)
    out, sizes, tails, flags = make_encoder(B, G)(arr_d, lens_d, mark=mark)
    frags: List[Optional[bytes]] = compact.fetch_chunks(out, sizes, mark=mark)
    flagged = np.nonzero(flags.cpu().numpy())[0].tolist()
    for i in flagged:
        frags[i] = None
    if G >= 2:
        # sort-emit bodies exclude the trailing literal element: append it
        # from the raw block bytes
        for i, t in enumerate(tails.tolist()):
            if frags[i] is not None and t > 0:
                b = blocks[i]
                frags[i] = frags[i] + literal_element(b[len(b) - t:])
    mark("tails")
    return frags, flagged


# =============================================================================
# Decoder
# =============================================================================

def _tag_scan(chunk_u8, clen, C: int):
    """Speculative element parse at every byte position: (next element
    position, produced bytes, literal length, literal start, offset), each
    (N, C)."""
    N = chunk_u8.shape[0]
    dev = chunk_u8.device
    tag = chunk_u8.to(_I32)
    pad = torch.cat([tag, tag.new_zeros(N, 8)], dim=1)
    idx = _arange(C, dev)
    b1 = pad[:, 1:C + 1]
    b2 = pad[:, 2:C + 2]
    typ = tag & 3
    arg = tag >> 2

    # literal: length from the tag or 1-2 extra bytes (the 62/63 four-byte
    # forms do not occur for <= 64 KiB blocks; read as the 2-byte form)
    lit_len = torch.where(arg < 60, arg + 1,
                          torch.where(arg == 60, b1 + 1, (b1 | (b2 << 8)) + 1))
    # header bytes 1 (arg < 60), 2 (arg 60) or 3, in int32 like every field
    # here (a where of two scalars would be int64)
    lit_hdr = 1 + (arg >= 60).to(_I32) + (arg > 60).to(_I32)

    # copy forms
    len1 = ((tag >> 2) & 7) + 4
    off1 = ((tag >> 5) << 8) | b1
    len2 = arg + 1
    off2 = b1 | (b2 << 8)

    is_lit = typ == 0
    is_c1 = typ == 1
    is_c2 = typ == 2           # typ 3 (4-byte offset) read as c2-like
    produced = torch.where(is_lit, lit_len, torch.where(is_c1, len1, len2))
    hdr = torch.where(is_lit, lit_hdr,
                      torch.where(is_c1, 2, 5 - 2 * is_c2.to(_I32)))
    nxt = torch.where(is_lit, idx + lit_hdr + lit_len, idx + hdr)
    nxt = torch.clamp(nxt, 0, C)
    lit = torch.where(is_lit, lit_len, 0)
    a = idx + lit_hdr          # literal source base
    offs = torch.where(is_c1, off1, off2)
    return nxt, produced, lit, a, offs


def _decode_block(chunk_u8, clen, dlen, C: int, B: int, mark=_no_mark):
    """Decode a batch of chunks into (N, B) uint8. mark(stage) is called
    on the host after each stage is enqueued ("tag_scan", "chain_marks",
    "output_map", "resolve_pass" per resolve pass, "resolve",
    "gather_output")."""
    nxt, produced, lit, a, offs = _tag_scan(chunk_u8, clen, C)
    mark("tag_scan")
    marks = lz._chain_marks(nxt, clen, C)
    mark("chain_marks")
    src = lz._output_map(marks, produced, lit, a, offs, dlen, B)
    mark("output_map")
    src, _ = lz._resolve(src, mark)
    mark("resolve")
    out = lz._gather_output(chunk_u8, src, dlen)
    mark("gather_output")
    return out


def make_decoder(chunk_cap: int, block_size: int):
    """The batched decoder: (chunks uint8[N, C], clens int32[N], dlens
    int32[N], mark=...) -> uint8[N, B] on the device the inputs lie on."""
    C, B = chunk_cap, block_size

    def decode(chunks, clens, dlens, mark=_no_mark):
        return _decode_block(chunks, clens, dlens, C=C, B=B, mark=mark)

    return decode


def decode_blocks(chunks: Sequence[bytes], dlens: Sequence[int],
                  block_size: int, *, device, mark=_no_mark) -> List[bytes]:
    """Decompress element-stream chunks (no varint preamble, each decoding
    to <= 64 KiB) on `device`, in batches of at most (32 << 20) // C
    chunks; mark as lz4_device.decode_blocks."""
    return lz.decode_batches(make_decoder, chunks, dlens, block_size,
                             device=device, mark=mark)
