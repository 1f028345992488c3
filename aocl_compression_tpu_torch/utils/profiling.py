"""Profiling hooks: an external-profiler trace and named spans, on
torch.profiler (the JAX package's are jax.profiler's); handle-level stats
live in api.unified.

Usage:
    from aocl_compression_tpu_torch.utils.profiling import trace, annotate

    with trace("prof-dir"):                 # host and device trace
        act.compress(h, data)

    with annotate("lz4-encode"):            # named span inside a trace
        ...

trace writes one Chrome trace (``*.pt.trace.json``, for Perfetto or
TensorBoard) into log_dir. Kernels the port launches through ctypes carry
no correlation to a span, so a trace shows them on the device's timeline
by name, not nested under the span that launched them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed region (CPU, and CUDA where a card is present)
    and write its Chrome trace into log_dir."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span (shows up in profiler timelines)."""
    with record_function(name):
        yield


class Stopwatch:
    """Wall-clock section timer collecting named durations: the bench's
    best-of-N aggregation helper."""

    def __init__(self):
        self.best = {}
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.best[name] = min(self.best.get(name, float("inf")), dt)
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in self.totals:
            lines.append(
                f"{name}: best {self.best[name] * 1e3:.2f} ms, avg "
                f"{self.totals[name] / self.counts[name] * 1e3:.2f} ms "
                f"(n={self.counts[name]})")
        return "\n".join(lines)
