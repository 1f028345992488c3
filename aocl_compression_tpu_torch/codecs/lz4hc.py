"""LZ4HC codec — hash-chain deep-search compressor, levels 1-12.

Tiers:
  HOST  — own C++ hash-chain encoder (csrc/lz4_host.cpp atpu_lz4hc_compress)
          via ctypes.
  TORCH — the exact-parse device encoder (ops/lz4_device.py, accel 1) with
          a level-scaled candidate search, on the handle's device.
Decode is LZ4's (codecs/lz4.decompress_blocks_fn): the host C++ decoder,
or the device decoder when device decode is enabled.

opt_var >= 2 selects the device encoder, as for lz4. Blocks over 64 KiB
take the host tier through the dispatch registry (the JAX package's
format route), so the audit names it.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..api.handle import Handle
from ..parallel import container
from ..runtime import native
from ..utils import dispatch
from ..utils.config import TIER_HOST, TIER_TORCH, get_config
from . import lz4_stitch
from .base import Codec
from .lz4 import _device_bodies, _oneshot_decompress, decompress_blocks_fn


class Lz4hcCodec(Codec):
    name = "lz4hc"
    version = "1.9.3-tpu"
    min_level, max_level, default_level = 1, 12, 9

    def compress_bound(self, n: int) -> int:
        cfg = get_config()
        return (native.lz4_compress_bound(n)
                + native.rap_frame_bound(n, cfg.default_block_size))

    def _block_size(self, handle: Handle) -> int:
        return handle.block_size or get_config().default_block_size

    def _level(self, handle: Handle) -> int:
        return self.clamp_level(handle.level or self.default_level)

    def _adapter(self, handle: Handle) -> container.BlockCodecAdapter:
        # device tier = throughput mode, engaged via opt_var (like lz4);
        # the default keeps the host hash-chain encoder
        cap = handle.max_tier if handle.opt_var >= 2 else TIER_HOST
        cb, ctier = dispatch.resolve_with_tier(
            self.name, "compress_blocks", cap, handle.opt_off)
        level = self._level(handle)
        if ctier == TIER_HOST:
            def compress(blocks):
                return cb(blocks, level, workers=handle.num_shards or None)
        else:
            # mem_limit caps the input bytes per device batch, as for lz4
            def compress(blocks):
                return cb(blocks, level, handle.device,
                          mem_limit=handle.mem_limit or None)
        return container.BlockCodecAdapter(
            compress_blocks=compress,
            decompress_blocks=decompress_blocks_fn(handle,
                                                   self._block_size(handle)))

    def compress(self, handle: Handle, data: bytes) -> bytes:
        rap = (handle.enable_rap if handle.enable_rap is not None
               else get_config().enable_rap and not container.st_fallback(
                   handle, handle.opt_var >= 2))
        if rap:
            out = container.compress_rapped(data, self._block_size(handle),
                                            self._adapter(handle))
            if out is not None:
                return out
        fn = dispatch.resolve(self.name, "compress", handle.max_tier,
                              handle.opt_off)
        return fn(data, self._level(handle))

    def decompress(self, handle: Handle, data: bytes,
                   expected_size: Optional[int] = None) -> bytes:
        out = container.decompress_rapped(data, self._adapter(handle))
        if out is not None:
            return out
        return _oneshot_decompress(data, expected_size)


@dispatch.register("lz4hc", "compress", TIER_HOST, "lz4hc_compress_host")
def _compress_host(data: bytes, level: int) -> bytes:
    return native.lz4hc_compress(data, level)


@dispatch.register("lz4hc", "compress_blocks", TIER_HOST,
                   "lz4hc_compress_blocks_host")
def _compress_blocks_host(blocks: Sequence[bytes], level: int, workers=None):
    from ..parallel import host_pool
    frags = host_pool.parallel_map(
        lambda b: native.lz4hc_compress_tail(b, level), blocks,
        workers=workers, total_bytes=sum(len(b) for b in blocks))
    return lz4_stitch.stitch(frags, blocks)


def device_params(level: int):
    """(depth, nw, lazy) of the device encoder at an lz4hc level, as the
    JAX package's lz4hc device tier sets them: the candidate depth scales
    with the level, levels >= 9 double the match-length cap (nw 32 ->
    132 bytes), levels >= 4 add one lazy-demotion step."""
    return (min(16, max(4, level + 2)), 32 if level >= 9 else 16,
            1 if level >= 4 else 0)


@dispatch.register("lz4hc", "compress_blocks", TIER_TORCH,
                   "lz4hc_compress_blocks_torch")
def _compress_blocks_torch(blocks: Sequence[bytes], level: int, device,
                           mem_limit=None):
    """HC-grade device encode on `device`: the sorted-order matcher
    examines the level-scaled number of previous same-hash candidates,
    exact greedy parse (accel 1), one batch per group of <= mem_limit
    input bytes."""
    from ..ops import lz4_device
    if max(len(b) for b in blocks) > lz4_device.MAX_DEVICE_BLOCK:
        # 16-bit position packing
        return dispatch.resolve_host("lz4hc", "compress_blocks")(blocks,
                                                                 level)
    depth, nw, lazy = device_params(level)
    return lz4_stitch.stitch_bodies(
        *_device_bodies(blocks, 1, device, mem_limit, depth=depth, nw=nw,
                        lazy=lazy), blocks)
