"""Shared host thread pool for RAP block fan-out.

The csrc codecs are stateless per call and ctypes releases the GIL for the
duration of each native call, so a plain thread pool over RAP chunks
approaches N-core scaling on the host tier (the reference's OpenMP worker
team, threads/threads.c:174-293).

Worker-count precedence mirrors the reference's numThreads semantics:
  env AOCL_HOST_THREADS > handle.num_shards > all cores.
Set AOCL_HOST_THREADS=1 to force serial host paths.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()

# Below this many payload bytes the per-task overhead dominates any win
# (the reference's small-stream single-thread fallback, threads.c:66-71).
MIN_PARALLEL_BYTES = 1 << 20


def max_workers() -> int:
    env = os.environ.get("AOCL_HOST_THREADS")
    if env:
        try:
            n = int(env)
            if n >= 1:
                return n
        except ValueError:
            pass
    return min(32, os.cpu_count() or 1)


def _get_pool() -> ThreadPoolExecutor:
    global _pool
    if _pool is None:
        with _pool_lock:
            if _pool is None:
                _pool = ThreadPoolExecutor(
                    max_workers=min(32, os.cpu_count() or 1),
                    thread_name_prefix="atpu-torch-rap")
    return _pool


def parallel_map(fn: Callable, items: Sequence, workers: Optional[int] = None,
                 total_bytes: Optional[int] = None) -> List:
    """Map fn over items with the shared pool, preserving order.

    ``workers`` is the requested thread count (None = auto: env override or
    all cores). Items are split into ``workers`` contiguous groups, one
    task per worker, so a requested count is honored exactly even though
    the pool is shared. Runs serially when parallelism cannot help (single
    item, one worker, or a tiny payload).
    """
    items = list(items)
    n = len(items)
    w = min(workers if workers and workers > 0 else max_workers(), n)
    if (w <= 1 or n < 2
            or (total_bytes is not None and total_bytes < MIN_PARALLEL_BYTES)):
        return [fn(it) for it in items]

    def run(lo: int, hi: int) -> List:
        return [fn(items[j]) for j in range(lo, hi)]

    bounds = [(i * n) // w for i in range(w + 1)]
    futs = [_get_pool().submit(run, bounds[i], bounds[i + 1])
            for i in range(w)]
    out: List = []
    for f in futs:
        out.extend(f.result())
    return out
