"""Measured tier-speed table consulted by dispatch's calibrated routing.

The reference's dispatcher only upgrades to a variant that is faster
(utils/utils.cpp:148-175). A higher tier is not assumed faster here
either: with calibrated=True, dispatch picks, among the eligible tiers,
the one with the best measured throughput for the (codec, op), and a
device tier with no measurement is never picked this way. It stays
reachable through the explicit opt-ins (opt_var >= 2, num_shards > 1,
AOCL_ENABLE_INSTRUCTIONS naming a device tier), which bypass the table.

The port's table starts empty: no device tier of the port has been
measured against the host tiers for this policy yet, and the JAX
package's figures were taken on other hardware. Until an entry exists,
calibrated routing keeps every op on its host tier.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from .config import TIER_HOST

# (codec, op) -> {tier: measured MB/s}
MEASURED_MBPS: Dict[Tuple[str, str], Dict[int, float]] = {}


def best_tier(codec: str, op: str,
              eligible: Sequence[int]) -> Optional[int]:
    """Fastest measured tier among ``eligible``; None if nothing measured
    and the host tier is not eligible. Unmeasured device tiers are
    skipped; ties go to the higher tier."""
    table = MEASURED_MBPS.get((codec, op))
    if not table:
        return TIER_HOST if TIER_HOST in eligible else None
    best = None
    for t in sorted(eligible):
        if t == TIER_HOST or t in table:
            speed = table.get(t, 0.0)
            if best is None or speed >= best[0]:
                best = (speed, t)
    return best[1] if best else None
