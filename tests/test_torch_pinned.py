"""The sha256 constants chip_smoke.py holds the port's snappy, zlib and
zstd streams against on the card (PINNED_SHA256 there) are the JAX
package's.

For each pinned call, the JAX package at its device tier
(AOCL_ENABLE_INSTRUCTIONS=XLA, JAX on the CPU) compresses the first
PINNED_BLOCKS blocks of chip_smoke.py's corpus (64 KiB blocks, seed 42);
the digest must be the constant, and the port on device="cpu" must give
the same bytes. After a change that alters those bytes on purpose, the
assertion message carries the new digest:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_pinned.py -q

PINNED_SURFACE_SHA256 holds the host surface's device-tier calls on the
same blocks (chip_smoke.py phase 12): the LZ4 frame at the device tier and
LZ4_compress_fast(acceleration 2). Their test checks the JAX package's
digest only: the port's bytes on these calls are held to the JAX
package's on the CPU by tests/test_torch_host_surface.py (at 4 KiB
blocks, to keep the plain encoder's CPU time small) and to this digest on
the card.
"""

import functools
import hashlib
import importlib.util
import os

import pytest

import aocl_compression_tpu as actpu
import aocl_compression_tpu_torch as act
from aocl_compression_tpu import native_api
from aocl_compression_tpu.codecs import lz4_frame
from aocl_compression_tpu.utils.config import TIER_XLA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()


@functools.lru_cache(maxsize=None)
def _data() -> bytes:
    return SMOKE.corpus(SMOKE.B * SMOKE.N)[:SMOKE.B * SMOKE.PINNED_BLOCKS]


@pytest.mark.parametrize("label", list(SMOKE.PINNED_CALLS))
def test_pinned_stream_is_the_jax_packages(monkeypatch, label):
    monkeypatch.setenv("AOCL_ENABLE_INSTRUCTIONS", "XLA")
    method, kw = SMOKE.PINNED_CALLS[label]
    ref = actpu.compress(actpu.setup(method, **kw), _data())
    digest = hashlib.sha256(ref).hexdigest()
    assert digest == SMOKE.PINNED_SHA256[label], (
        f"{label}: the JAX package's stream is {len(ref)} B, sha256 "
        f"{digest}")
    assert act.compress(act.setup(method, device="cpu", **kw),
                        _data()) == ref


SURFACE_CALLS = {
    "lz4 frame": lambda d: lz4_frame.compress_frame(d, max_tier=TIER_XLA),
    "LZ4_compress_fast": lambda d: native_api.LZ4_compress_fast(d, 2),
}


@pytest.mark.parametrize("label", list(SMOKE.PINNED_SURFACE_SHA256))
def test_pinned_surface_is_the_jax_packages(monkeypatch, label):
    monkeypatch.setenv("AOCL_ENABLE_INSTRUCTIONS", "XLA")
    ref = SURFACE_CALLS[label](_data())
    digest = hashlib.sha256(ref).hexdigest()
    assert digest == SMOKE.PINNED_SURFACE_SHA256[label], (
        f"{label}: the JAX package's output is {len(ref)} B, sha256 "
        f"{digest}")
