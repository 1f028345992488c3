"""Timing + handle-level stats.

The stats the unified API records when measure_stats is on
(reference api/api.cpp:58-75): speed = bytes * 1000 / ns (MB/s). Device
work ends in a device-to-host copy inside the codec, so the host clock
around a call covers the device's work.
"""

from __future__ import annotations

import time


class Timer:
    __slots__ = ("_t0", "elapsed_ns")

    def __init__(self):
        self._t0 = 0
        self.elapsed_ns = 0

    def start(self) -> None:
        self._t0 = time.perf_counter_ns()

    def stop(self) -> int:
        self.elapsed_ns = time.perf_counter_ns() - self._t0
        return self.elapsed_ns


def speed_mbps(num_bytes: int, elapsed_ns: int) -> float:
    """speed = bytes*1000/ns, the reference's MB/s definition (api/api.cpp:74)."""
    if elapsed_ns <= 0:
        return 0.0
    return num_bytes * 1000.0 / elapsed_ns
