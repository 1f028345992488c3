"""Kernel-variant dispatch registry + audit instrumentation.

A codec registers one implementation per backend tier (HOST / TORCH /
KERNEL / MULTI, see utils.config). ``resolve`` picks the highest registered
tier <= the allowed cap (env-capped, handle-capped). Every resolved call
records a hit so tests can assert which variants ran — the reference's
AOCL_UNIT_TEST hit-counter audit (utils/utils.cpp:238-267).

This registry is the port's own: the JAX package keeps a separate one, and
neither writes into the other.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Callable, Dict, Optional, Tuple

from .config import TIER_HOST, forced_tier_from_env, max_tier_from_env

_lock = threading.Lock()
# (codec, op) -> {tier: (name, fn)}
_registry: Dict[Tuple[str, str], Dict[int, Tuple[str, Callable]]] = {}
_hits: Counter = Counter()          # variant name -> hit count
_hit_tiers: Dict[str, int] = {}     # variant name -> tier
_audit_enabled = False


def register(codec: str, op: str, tier: int, name: str):
    """Decorator: register ``fn`` as the implementation of (codec, op) at tier."""
    def deco(fn: Callable) -> Callable:
        with _lock:
            _registry.setdefault((codec, op), {})[tier] = (name, fn)
        return fn
    return deco


def resolve(codec: str, op: str, max_tier: Optional[int] = None,
            opt_off: bool = False, calibrated: bool = False) -> Callable:
    """Pick the best registered variant within the allowed tier cap.

    opt_off=True forces tier 0, the AOCL_DISABLE_OPT / optOff semantic.

    calibrated=True applies the measured-speed policy (utils.calibration):
    among eligible tiers, pick the fastest measured one instead of the
    highest; a tier never measured is never picked this way. An explicit
    AOCL_ENABLE_INSTRUCTIONS tier name overrides the table. Codecs pass
    calibrated=True on their default paths and False when the caller
    opted a tier in (opt_var >= 2, num_shards > 1).
    """
    return resolve_with_tier(codec, op, max_tier, opt_off, calibrated)[0]


def resolve_with_tier(codec: str, op: str, max_tier: Optional[int] = None,
                      opt_off: bool = False, calibrated: bool = False):
    """Like resolve, but also returns the chosen tier so callers can pass
    tier-specific context (e.g. the handle's device to a device tier)."""
    cap = TIER_HOST if opt_off else min(
        max_tier_from_env(), max_tier if max_tier is not None else 99)
    impls = _registry.get((codec, op))
    if not impls:
        raise KeyError(f"no implementation registered for {codec}.{op}")
    eligible = [t for t in impls if t <= cap]
    if not eligible:
        # the lowest registered tier is the floor every op provides
        eligible = [min(impls)]
    tier = max(eligible)
    if calibrated and tier > TIER_HOST and forced_tier_from_env() is None:
        from . import calibration
        best = calibration.best_tier(codec, op, eligible)
        if best is not None:
            tier = best
    name, fn = impls[tier]
    _record_hit(name, tier)
    return fn, tier


def registered_tiers(codec: str, op: str):
    """The tiers, sorted, that this registry holds for (codec, op)."""
    return sorted(_registry.get((codec, op), {}))


def resolve_host(codec: str, op: str) -> Callable:
    """The host-tier variant of `codec`'s `op`, resolved so the audit
    records the route: the device tiers take their format routes (blocks
    over 64 KiB, blocks an encoder flags, tiny inputs) through it."""
    return resolve(codec, op, TIER_HOST)


# --- audit instrumentation (reference utils/utils.cpp:238-314) --------------

def enable_audit(on: bool = True) -> None:
    global _audit_enabled
    with _lock:
        _audit_enabled = on
        if on:
            _hits.clear()
            _hit_tiers.clear()


def reset_audit() -> None:
    with _lock:
        _hits.clear()
        _hit_tiers.clear()


def _record_hit(name: str, tier: int) -> None:
    if _audit_enabled:
        with _lock:
            _hits[name] += 1
            _hit_tiers[name] = tier


def audit_hits() -> Dict[str, int]:
    with _lock:
        return dict(_hits)


def validate_tier_access(max_allowed_tier: int) -> bool:
    """True iff no variant above ``max_allowed_tier`` ran since the last
    reset (validate_simd_func_access, utils/utils.cpp:252-267)."""
    with _lock:
        return all(t <= max_allowed_tier for t in _hit_tiers.values())
