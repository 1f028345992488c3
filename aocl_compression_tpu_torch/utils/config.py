"""Typed configuration with environment overrides.

Backend tiers (which implementation of a codec runs), lowest first:

  0 = HOST    — host C++ path (csrc/libaocl_tpu_host.so)
  1 = TORCH   — PyTorch tensor pipeline on the handle's device. The
                serial-scan kernels (csrc/zstd_scan.cu, csrc/inflate_scan.cu,
                csrc/entropy_scan.cu, csrc/chain_scan.cu) belong to this
                tier: they replace the JAX package's lax.scans and fori_loops,
                which are XLA-tier code, and their plain versions cannot
                serve on the card (launch-bound loops: tens of ms to seconds
                per batch; the chain marking's matrix squarings: GBs of
                memory traffic).
  2 = KERNEL  — hand-written CUDA kernels for the hot stages: the
                compaction (csrc/compact.cu, the JAX package's Pallas
                kernel); a TORCH cap runs its plain version instead
  3 = MULTI   — several devices: parallel/sharded.py (block data
                parallelism over a list of devices in one process) and
                parallel/distributed.py (over a torch.distributed group)

Env vars, read like the JAX package reads them:
  AOCL_ENABLE_INSTRUCTIONS ∈ {HOST, TORCH, KERNEL, MULTI} — caps the tier.
    The JAX package's names (XLA, PALLAS, MESH) and the reference's ISA
    names (SSE2, AVX, AVX2, AVX512) are accepted and mapped.
  AOCL_DISABLE_OPT — any value forces tier 0.
  AOCL_ENABLE_LOG ∈ {ERR, INFO, DEBUG, TRACE} — log level.
  AOCL_DEVICE_DECODE — a value other than "0" or "" routes RAP decode to
    the device tier (overrides FrameworkConfig.device_decode).
"""

from __future__ import annotations

import dataclasses
import os

TIER_HOST = 0
TIER_TORCH = 1
TIER_KERNEL = 2
TIER_MULTI = 3

_TIER_NAMES = {"HOST": TIER_HOST, "TORCH": TIER_TORCH, "KERNEL": TIER_KERNEL,
               "MULTI": TIER_MULTI,
               # the JAX package's tier names
               "XLA": TIER_TORCH, "PALLAS": TIER_KERNEL, "MESH": TIER_MULTI,
               # the reference's ISA names
               "SSE2": TIER_HOST, "AVX": TIER_TORCH, "AVX2": TIER_KERNEL,
               "AVX512": TIER_MULTI}

TIER_LABELS = {v: k for k, v in list(_TIER_NAMES.items())[:4]}


def max_tier_from_env(default: int = TIER_MULTI) -> int:
    """Resolve the maximum allowed backend tier (env > default)."""
    if os.environ.get("AOCL_DISABLE_OPT") is not None:
        return TIER_HOST
    val = os.environ.get("AOCL_ENABLE_INSTRUCTIONS")
    if val:
        return _TIER_NAMES.get(val.strip().upper(), default)
    return default


def forced_tier_from_env():
    """Tier explicitly named by AOCL_ENABLE_INSTRUCTIONS, or None. An
    explicit device-tier name is a user demand to run that backend: it
    bypasses the measured-speed routing in dispatch (utils.calibration)."""
    if os.environ.get("AOCL_DISABLE_OPT") is not None:
        return TIER_HOST
    val = os.environ.get("AOCL_ENABLE_INSTRUCTIONS")
    if val:
        return _TIER_NAMES.get(val.strip().upper())
    return None


@dataclasses.dataclass
class FrameworkConfig:
    """Global knobs (the reference's CMake option matrix, at run time)."""

    # Per-codec enable switches (reference: AOCL_EXCLUDE_<CODEC> options).
    enabled_codecs: tuple = ("lz4", "lz4hc", "snappy", "zlib", "zstd",
                             "bzip2", "lzma")
    # RAP multi-block container support (reference: AOCL_ENABLE_THREADS).
    enable_rap: bool = True
    # Default block size; the RAP chunking invariant is chunk >= codec
    # search window.
    default_block_size: int = 64 * 1024
    # Device decode opt-in, as in the JAX package: RAP decode runs on the
    # host C++ decoder unless this is set (or env AOCL_DEVICE_DECODE=1).
    device_decode: bool = False


def device_decode_enabled() -> bool:
    if os.environ.get("AOCL_DEVICE_DECODE") is not None:
        return os.environ["AOCL_DEVICE_DECODE"] not in ("0", "")
    return _config.device_decode


_config = FrameworkConfig()


def get_config() -> FrameworkConfig:
    return _config


def set_config(**kwargs) -> FrameworkConfig:
    global _config
    _config = dataclasses.replace(_config, **kwargs)
    return _config
