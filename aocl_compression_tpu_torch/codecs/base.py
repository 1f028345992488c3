"""Codec protocol — the adapter signature every codec normalizes to.

Parity with the reference's codec adapters (api/codec.cpp:82-437) and the
fn-pointer table entry {name, version, compress, decompress, setup,
destroy} (api/codec.h:155-174).
"""

from __future__ import annotations

from typing import Optional

from ..api.handle import Handle
from ..utils.config import TIER_HOST, forced_tier_from_env


class Codec:
    """Base codec. Subclasses provide host and device paths.

    `compress`/`decompress` are the adapter-level entry points used by the
    unified API: bytes in, bytes out, honoring handle.level / opt_off /
    max_tier / device and the RAP container setting.
    """

    name: str = ""
    version: str = ""
    min_level: int = 0
    max_level: int = 0
    default_level: int = 0

    def setup(self, handle: Handle) -> None:
        """Resolve kernel variants / allocate work state."""

    def destroy(self, handle: Handle) -> None:
        handle.state = None

    def clamp_level(self, level: int) -> int:
        return max(self.min_level, min(self.max_level, level))

    def compress_bound(self, n: int) -> int:
        raise NotImplementedError

    def compress(self, handle: Handle, data: bytes) -> bytes:
        raise NotImplementedError

    def decompress(self, handle: Handle, data: bytes,
                   expected_size: Optional[int] = None) -> bytes:
        raise NotImplementedError


def device_opt_in(handle: Handle) -> bool:
    """Explicit device-tier request: opt_var >= 2 (the lz4 accel
    convention), num_shards > 1, or AOCL_ENABLE_INSTRUCTIONS naming a
    device tier. Without one, dispatch routes by measured speed
    (utils.calibration)."""
    return (handle.opt_var >= 2 or handle.num_shards > 1
            or (forced_tier_from_env() or TIER_HOST) > TIER_HOST)
