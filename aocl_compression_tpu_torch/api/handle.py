"""Compression handle — parity with aocl_compression_desc.

Reference struct: api/aocl_compression.h:125-152. Field map:

  level, optVar        -> level, opt_var
  numThreads           -> num_shards (host tier: worker count; device
                          tiers: MULTI shards per host, 0 = auto, one a
                          device)
  numMPIranks          -> num_hosts  (MULTI: shards = num_shards x hosts)
  memLimit             -> mem_limit  (input bytes per device batch)
  measureStats + c/dSize c/dTime c/dSpeed -> measure_stats + Stats
  optOff, optLevel     -> opt_off, max_tier (backend-tier cap, see
                          utils.config)
  (new)                -> device: where the device tiers run; setup
                          resolves None to cuda (utils.device)
  dictionary           -> dictionary (zstd; keeps zstd on the host tier)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass
class Stats:
    """Populated by compress/decompress when measure_stats is on
    (reference: api/api.cpp:70-75, 111-116)."""
    c_size: int = 0
    c_time_ns: int = 0
    c_speed_mbps: float = 0.0
    d_size: int = 0
    d_time_ns: int = 0
    d_speed_mbps: float = 0.0


@dataclasses.dataclass
class Handle:
    codec: str = ""
    level: int = 0
    opt_var: int = 0
    num_shards: int = 0          # workers / MULTI shards; 0 = auto
    num_hosts: int = 0           # reference numMPIranks (reserved there)
    mem_limit: int = 0
    measure_stats: bool = False
    opt_off: bool = False        # force host tier (reference optOff)
    max_tier: Optional[int] = None   # cap backend tier (reference optLevel)
    block_size: int = 0          # 0 = codec default chunking
    enable_rap: Optional[bool] = None  # None = framework config default
    device: Optional[torch.device] = None  # resolved by setup
    dictionary: Optional[bytes] = None   # zstd dictionary (host tier)
    stats: Stats = dataclasses.field(default_factory=Stats)
    state: Any = None            # codec workmem (reference workBuf)
    _setup_done: bool = False
