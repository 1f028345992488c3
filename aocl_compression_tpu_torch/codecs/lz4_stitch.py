"""LZ4 fragment stitching for block-parallel streams.

An LZ4 fragment's final sequence is literal-only with no offset field, so raw
concatenation of fragments is ambiguous to a serial decoder. The reference
fixes this with serial boundary surgery after the parallel region
(algos/lz4/lz4.c:2736-2930): drop each fragment's final literal-only
sequence and splice those literal bytes into the *next* fragment's first
sequence by rewriting its token/litlen header.

Block compressors (host C++ or the device pipeline) return
(stream, tail_lits); `stitch` produces the per-chunk byte regions and their
decoded lengths for the RAP frame. Region k (k < n-1) ends on a match; the
final region carries the stream's closing literal-only sequence.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def final_sequence_len(tail_lits: int) -> int:
    """Byte length of a literal-only final sequence holding `tail_lits`."""
    n = 1 + tail_lits  # token + literal bytes
    if tail_lits >= 15:
        n += 1 + (tail_lits - 15) // 255
    return n


def literal_sequence(lits: bytes) -> bytes:
    """Encode a literal-only (final) sequence."""
    n = len(lits)
    out = bytearray()
    if n >= 15:
        out.append(15 << 4)
        rest = n - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    else:
        out.append(n << 4)
    out += lits
    return bytes(out)


def prepend_literals(lits: bytes, body: bytes) -> bytes:
    """Splice `lits` in front of `body`'s first sequence (token surgery)."""
    if not lits:
        return body
    token = body[0]
    orig_lit = token >> 4
    pos = 1
    if orig_lit == 15:
        while True:
            b = body[pos]
            pos += 1
            orig_lit += b
            if b != 255:
                break
    new_lit = orig_lit + len(lits)
    hdr = bytearray()
    if new_lit >= 15:
        hdr.append((15 << 4) | (token & 0x0F))
        rest = new_lit - 15
        while rest >= 255:
            hdr.append(255)
            rest -= 255
        hdr.append(rest)
    else:
        hdr.append((new_lit << 4) | (token & 0x0F))
    return bytes(hdr) + lits + body[pos:]


def stitch(fragments: Sequence[Tuple[bytes, int]],
           blocks: Sequence[bytes]) -> Tuple[List[bytes], List[int]]:
    """Merge per-block full fragment streams into RAP chunk regions.

    fragments[k] = (full fragment stream, tail literal count) for blocks[k].
    """
    bodies = [s[:len(s) - final_sequence_len(t)] for s, t in fragments]
    return stitch_bodies(bodies, [t for _, t in fragments], blocks)


def stitch_bodies(bodies: Sequence[bytes], tails: Sequence[int],
                  blocks: Sequence[bytes]) -> Tuple[List[bytes], List[int]]:
    """Merge per-block (body, tail) pairs into RAP chunk regions.

    bodies[k] excludes the final literal-only sequence (the device encoder
    emits exactly this); tails[k] is its literal count. Returns (chunk byte
    regions, decoded length per region); concatenating the regions yields
    one valid serial LZ4 stream, and each region is independently decodable
    to its decoded length.
    """
    chunks: List[bytes] = []
    dlens: List[int] = []
    pending = b""  # literal bytes deferred across the boundary
    for body, tail, blk in zip(bodies, tails, blocks):
        tail_bytes = blk[len(blk) - tail:] if tail else b""
        if body:
            chunks.append(prepend_literals(pending, body))
            dlens.append(len(pending) + len(blk) - tail)
            pending = tail_bytes
        else:
            # all-literal block: defer everything (reference's
            # dst_trap_size == 0 case, lz4.c:2814-2830)
            chunks.append(b"")
            dlens.append(0)
            pending = pending + tail_bytes
    # closing literal-only sequence attaches to the last non-empty position
    chunks[-1] = chunks[-1] + literal_sequence(pending)
    dlens[-1] += len(pending)
    return chunks, dlens
