"""RAP container assembly/disassembly — codec-agnostic block parallelism.

Blocks are compressed as a batch (on the device, or on the host's thread
pool) and assembled around a byte-compatible RAP frame (csrc/rap.cpp), the
stream layout of the reference's threads runtime (threads/threads.c).

Stream layout:  [RAP frame][stream preamble?][chunk 0][chunk 1]...[chunk N-1]

Chunk regions are format-valid fragments whose concatenation is itself a
valid single-shot stream (each block is compressed with fresh history;
LZ4 boundary literals are merged by codecs/lz4_stitch.py). A legacy
decoder can skip the RAP frame and decode serially; a parallel decoder
fans out per entry using the recorded {offset, length, decoded length}
triplets.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

from ..runtime import native

# core count cannot change within a process
_HOST_CORES = os.cpu_count() or 1


class BlockCodecAdapter:
    """Batch block compress/decompress hooks a codec plugs into the container.

    compress_blocks: list of raw input blocks ->
        (chunk regions, decoded length per region). Regions are format-valid,
        concatenatable, carry NO stream preamble, and sum(dlens) must equal
        the total input length.
    decompress_blocks: (chunk regions, decoded lengths) -> decoded blocks.
    """

    def __init__(self,
                 compress_blocks: Callable[[Sequence[bytes]],
                                           Tuple[List[bytes], List[int]]],
                 decompress_blocks: Callable[[Sequence[bytes], Sequence[int]],
                                             List[bytes]],
                 preamble: Optional[Callable[[int], bytes]] = None):
        self.compress_blocks = compress_blocks
        self.decompress_blocks = decompress_blocks
        # Optional whole-stream preamble (snappy: varint of total length).
        self.preamble = preamble


def split_blocks(data: bytes, block_size: int) -> List[bytes]:
    return [data[i:i + block_size] for i in range(0, len(data), block_size)]


def block_groups(blocks: Sequence[bytes],
                 mem_limit: Optional[int]) -> List[List[bytes]]:
    """Split blocks into groups of <= mem_limit input bytes, one device
    batch each (the reference's memLimit semantics, codec_bench -m); one
    group when mem_limit is unset. A group only bounds a device batch, never
    the stream layout (the device tiers apply it below the stitcher)."""
    if not mem_limit:
        return [list(blocks)]
    groups, cur, size = [], [], 0
    for b in blocks:
        if cur and size + len(b) > mem_limit:
            groups.append(cur)
            cur, size = [], 0
        cur.append(b)
        size += len(b)
    if cur:
        groups.append(cur)
    return groups


def st_fallback(handle, device_opted: bool) -> bool:
    """The reference's single-thread fallback (threads/threads.c:66-97):
    when exactly one worker would run the serial host path, compress
    single-shot instead of into the container. Device tiers keep the
    container, as does an explicit num_shards or block_size request."""
    if device_opted or (handle.num_shards or 0) > 1:
        return False
    if handle.block_size:  # an explicit chunking request = container use
        return False
    return _HOST_CORES == 1


def compress_rapped(data: bytes, block_size: int,
                    adapter: BlockCodecAdapter) -> Optional[bytes]:
    """Compress into a RAP-framed block-parallel stream.

    Returns None when the input is too small to benefit (< 2 blocks), the
    reference's single-thread fallback for small streams (threads.c:66-71).
    Callers then use their single-shot path.
    """
    blocks = split_blocks(data, block_size)
    n = len(blocks)
    if n < 2:
        return None
    chunks, dlens = adapter.compress_blocks(blocks)
    if sum(dlens) != len(data):
        raise ValueError("block codec dlens do not cover the input")
    pre = adapter.preamble(len(data)) if adapter.preamble else b""
    frame_len = native.rap_frame_len(n)
    offsets, lens = [], []
    pos = frame_len + len(pre)
    for ch in chunks:
        offsets.append(pos)
        lens.append(len(ch))
        pos += len(ch)
    frame = native.rap_write(n, offsets, lens, dlens)
    return frame + pre + b"".join(chunks)


def decompress_rapped(data: bytes,
                      adapter: BlockCodecAdapter) -> Optional[bytes]:
    """Decompress a RAP-framed stream; None when no RAP frame is present
    (legacy single-shot stream — caller handles it)."""
    parsed = native.rap_parse(data)
    if parsed is None:
        return None
    offsets, lens, dlens = parsed
    end = int(offsets[-1]) + int(lens[-1])
    if end > len(data):
        raise ValueError("RAP entries exceed stream bounds (truncated?)")
    chunks = [bytes(data[o:o + l]) for o, l in zip(offsets, lens)]
    blocks = adapter.decompress_blocks(chunks, [int(d) for d in dlens])
    out = b"".join(blocks)
    if len(out) != int(dlens.sum()):
        raise ValueError("RAP decode length mismatch")
    return out


def skip_rap_frame(data: bytes) -> bytes:
    """Strip a RAP frame for legacy serial decode — aocl_skip_rap_frame_mt
    parity (api/aocl_threads.h:133)."""
    return data[native.rap_skip(data):]
