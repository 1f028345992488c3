""".xz container (LZMA2) over the LZMA codec of the shared host library —
the reference's xz-utils-compatible shim (lzma_easy_buffer_encode /
lzma_stream_buffer_decode), host code as in the JAX package, byte for byte.

The .xz stream format: stream header/footer, block header, the LZMA2 chunk
layer, index, CRC32 check, around csrc/lzma.cpp's raw streams. Encoding
uses independent LZMA2 chunks (dict+state+props reset per chunk): every
produced stream decodes with stock xz / CPython lzma. Decoding carries the
full LZMA2 state across chunks (dictionary, rep distances, probability
model: the stateful context atpu_lzma2_*), so stock multi-chunk streams of
any size decode.
"""

from __future__ import annotations

import struct

import numpy as np

from ..runtime import native

_MAGIC = b"\xfd7zXZ\x00"
_FOOTER_MAGIC = b"YZ"
_CHECK_CRC32 = 0x01
_LZMA2_FILTER_ID = 0x21
# chunk input size: compressed size field is 16 bits, so keep inputs at
# 60 KiB and fall back to uncompressed chunks when expansion occurs
_CHUNK = 60000


def _vli(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_vli(data: bytes, pos: int):
    n = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        if shift > 63:
            raise ValueError("xz: bad VLI")


def _lzma2_dict_prop(dict_size: int) -> int:
    # smallest encodable dict size >= dict_size (spec: 2/3 * 2^k ladder)
    for p in range(41):
        base = 2 | (p & 1)
        sz = base << (p // 2 + 11)
        if sz >= dict_size:
            return p
    return 40


def _encode_lzma2(data: bytes, level: int) -> tuple:
    """LZMA2 chunk stream (ends with 0x00) + the props byte used."""
    out = bytearray()
    props = None
    for off in (range(0, len(data), _CHUNK) if data else []):
        chunk = data[off:off + _CHUNK]
        alone = native.lzma_compress(chunk, level)
        # ALONE layout: 1B props, 4B dictSize, 8B usize, raw stream
        p = alone[0]
        raw = alone[13:]
        if props is None:
            props = p
        usize = len(chunk)
        if len(raw) < len(chunk) and len(raw) <= 65536 and p == props:
            ctrl = 0x80 | (3 << 5) | ((usize - 1) >> 16)  # reset all+props
            out.append(ctrl)
            out += struct.pack(">HH", (usize - 1) & 0xFFFF, len(raw) - 1)
            out.append(p)
            out += raw
        else:  # incompressible (or props drift): uncompressed chunk
            out.append(0x01)  # dict reset + uncompressed
            out += struct.pack(">H", usize - 1)
            out += chunk
    out.append(0x00)  # an empty block is just the terminator
    return bytes(out), props if props is not None else 0


def _scan_lzma2(data: bytes, pos: int, limit: int) -> tuple:
    """Structural walk of an LZMA2 chunk stream: (total usize, end pos)."""
    total = 0
    while True:
        if pos >= limit:
            raise ValueError("xz: truncated LZMA2 stream")
        ctrl = data[pos]
        pos += 1
        if ctrl == 0x00:
            return total, pos
        if ctrl in (0x01, 0x02):
            usize = struct.unpack_from(">H", data, pos)[0] + 1
            pos += 2 + usize
            total += usize
            continue
        if ctrl < 0x80:
            raise ValueError("xz: bad LZMA2 control byte")
        usize = (((ctrl & 0x1F) << 16)
                 | struct.unpack_from(">H", data, pos)[0]) + 1
        csize = struct.unpack_from(">H", data, pos + 2)[0] + 1
        pos += 4
        if ((ctrl >> 5) & 3) >= 2:
            pos += 1  # props byte
        pos += csize
        total += usize


def _decode_lzma2(data: bytes, pos: int, limit: int) -> tuple:
    """Decode an LZMA2 chunk stream with FULL state continuation: chunks
    without dict/state reset keep the probability model, rep distances,
    and dictionary of the previous chunks (the stateful C context
    atpu_lzma2_*), so stock multi-chunk streams of any size decode."""
    total, _end = _scan_lzma2(data, pos, limit)
    out = np.empty(total, dtype=np.uint8)
    lib = native.get_lib()
    ctx = lib.atpu_lzma2_ctx_new()
    if not ctx:
        raise MemoryError("lzma2 ctx")
    try:
        op = 0
        dict_base = 0
        src_all = np.frombuffer(data, dtype=np.uint8)
        outp = out.ctypes.data_as(native._u8p)
        while True:
            ctrl = data[pos]
            pos += 1
            if ctrl == 0x00:
                return out[:op].tobytes(), pos
            if ctrl in (0x01, 0x02):
                if ctrl == 0x01:
                    dict_base = op
                usize = struct.unpack_from(">H", data, pos)[0] + 1
                pos += 2
                out[op:op + usize] = src_all[pos:pos + usize]
                pos += usize
                op += usize
                lib.atpu_lzma2_mark_uncompressed(ctx)
                continue
            if ctrl < 0x80:
                raise ValueError("xz: bad LZMA2 control byte")
            reset = (ctrl >> 5) & 3
            usize = (((ctrl & 0x1F) << 16)
                     | struct.unpack_from(">H", data, pos)[0]) + 1
            csize = struct.unpack_from(">H", data, pos + 2)[0] + 1
            pos += 4
            props = -1
            if reset >= 2:
                props = data[pos]
                pos += 1
            if reset == 3:
                dict_base = op
            chunk = src_all[pos:pos + csize]
            if len(chunk) < csize:
                raise ValueError("xz: truncated LZMA2 chunk")
            pos += csize
            r = lib.atpu_lzma2_decode_chunk(
                ctx, chunk.ctypes.data_as(native._u8p) if csize else None,
                csize, outp, total, op, usize, props,
                1 if reset >= 1 else 0, dict_base)
            if r != usize:
                raise ValueError("xz: corrupt LZMA2 chunk")
            op += usize
    finally:
        lib.atpu_lzma2_ctx_free(ctx)


def _one_block(data: bytes, level: int) -> tuple:
    """(block bytes incl. padding+check, unpadded_size, usize)."""
    body, _props = _encode_lzma2(data, level)
    dict_prop = _lzma2_dict_prop(1 << 24)
    filt = _vli(_LZMA2_FILTER_ID) + _vli(1) + bytes([dict_prop])
    hdr_body = b"\x00" + filt
    real = len(hdr_body) + 1 + 4
    pad = (-real) % 4
    hdr_body += b"\x00" * pad
    size_byte = (len(hdr_body) + 1 + 4) // 4 - 1
    hdr_wo_crc = bytes([size_byte]) + hdr_body
    block_header = hdr_wo_crc + struct.pack("<I", native.crc32(hdr_wo_crc))
    block = block_header + body
    block += b"\x00" * ((-len(body)) % 4)
    block += struct.pack("<I", native.crc32(data))
    unpadded = len(block_header) + len(body) + 4
    return block, unpadded, len(data)


def xz_compress(data: bytes, level: int = 6,
                block_size: int = 0) -> bytes:
    """lzma_easy_buffer_encode parity: one-shot .xz stream (CRC32 check).

    block_size > 0 splits the payload into INDEPENDENT xz blocks (the
    layout `xz -T`/`--block-size` produces): the stream index records
    every block, enabling random access / parallel decode — the xz
    analog of the RAP container. Stock xz reads either layout.
    """
    if block_size > 0 and data:
        pieces = [data[i:i + block_size]
                  for i in range(0, len(data), block_size)]
    else:
        pieces = [data]
    blocks = [_one_block(p, level) for p in pieces]

    idx_body = b"\x00" + _vli(len(blocks))
    for _, unpadded, usize in blocks:
        idx_body += _vli(unpadded) + _vli(usize)
    idx_body += b"\x00" * ((-len(idx_body)) % 4)
    index = idx_body + struct.pack("<I", native.crc32(idx_body))

    flags = bytes([0x00, _CHECK_CRC32])
    header = _MAGIC + flags + struct.pack("<I", native.crc32(flags))
    back_size = len(index) // 4 - 1
    footer_body = struct.pack("<I", back_size) + flags
    footer = (struct.pack("<I", native.crc32(footer_body)) + footer_body
              + _FOOTER_MAGIC)
    return (header + b"".join(b for b, _, _ in blocks) + index + footer)


def xz_index(data: bytes):
    """Parse the stream index from the footer: list of
    (block_offset, unpadded_size, uncompressed_size) — the random-access
    map (checkpoint/resume analog of the RAP entries)."""
    if len(data) < 12 or data[-2:] != _FOOTER_MAGIC:
        raise ValueError("xz: bad footer")
    back_size = struct.unpack_from("<I", data, len(data) - 8)[0]
    idx_len = (back_size + 1) * 4
    idx_start = len(data) - 12 - idx_len
    idx = data[idx_start:idx_start + idx_len]
    if idx[:1] != b"\x00":
        raise ValueError("xz: bad index")
    nrec, p = _read_vli(idx, 1)
    out = []
    off = 12  # first block offset (after the stream header)
    for _ in range(nrec):
        unpadded, p = _read_vli(idx, p)
        usize, p = _read_vli(idx, p)
        out.append((off, unpadded, usize))
        off += unpadded + ((-unpadded) % 4)
    return out


def xz_decompress_block(data: bytes, offset: int) -> bytes:
    """Random access: decode the single block starting at `offset` (from
    xz_index) without touching the rest of the stream."""
    size_byte = data[offset]
    if size_byte == 0x00:
        raise ValueError("xz: offset points at the index")
    hdr_len = (size_byte + 1) * 4
    pos = offset + hdr_len
    plain, _pos = _decode_lzma2(data, pos, len(data))
    return plain


def xz_decompress(data: bytes) -> bytes:
    """lzma_stream_buffer_decode parity: one-shot .xz decode with CRC32/
    CRC-none verification (CRC64/SHA256 checks are skipped with the
    lengths still validated)."""
    if len(data) < 32 or data[:6] != _MAGIC:
        raise ValueError("xz: bad stream header")
    flags = data[6:8]
    if struct.unpack_from("<I", data, 8)[0] != native.crc32(flags):
        raise ValueError("xz: stream header crc")
    check_id = flags[1] & 0x0F
    check_len = {0: 0, 1: 4, 4: 8, 10: 32}.get(check_id)
    if check_len is None:
        raise ValueError("xz: unknown check type")
    if data[-2:] != _FOOTER_MAGIC:
        raise ValueError("xz: bad footer")

    out = bytearray()
    pos = 12
    while True:
        size_byte = data[pos]
        if size_byte == 0x00:  # index indicator: blocks done
            break
        hdr_len = (size_byte + 1) * 4
        hdr = data[pos:pos + hdr_len]
        if struct.unpack_from("<I", hdr, hdr_len - 4)[0] != \
                native.crc32(hdr[:hdr_len - 4]):
            raise ValueError("xz: block header crc")
        bflags = hdr[1]
        nfilters = (bflags & 3) + 1
        p = 2
        if bflags & 0x40:  # compressed size present
            _, p = _read_vli(hdr, p)
        if bflags & 0x80:  # uncompressed size present
            _, p = _read_vli(hdr, p)
        lzma2 = False
        for _ in range(nfilters):
            fid, p = _read_vli(hdr, p)
            plen, p = _read_vli(hdr, p)
            p += plen
            if fid == _LZMA2_FILTER_ID:
                lzma2 = True
        if not lzma2:
            raise ValueError("xz: unsupported filter chain")
        pos += hdr_len
        plain, pos = _decode_lzma2(data, pos, len(data))
        pos += (-(pos - 12)) % 4  # block padding to 4-alignment
        if check_id == 1:
            want = struct.unpack_from("<I", data, pos)[0]
            if native.crc32(plain) != want:
                raise ValueError("xz: block crc32 mismatch")
        pos += check_len
        out += plain
    return bytes(out)
