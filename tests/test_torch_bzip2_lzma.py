"""The port's bzip2 and lzma codecs against the JAX package's: the device
BWT (ops/bwt_device.py) forward and inverse, the lzma match-finder assist
(ops/lzma_assist.py: _grid_parse at G = 1, the matcher, elect_sequences),
the device-tier streams (bzip2_compress_torch, lzma_compress_torch) and
the host-tier streams, byte-identical to the JAX package's host and XLA
tiers; stdlib bz2 / lzma read every stream, and both codecs round-trip
through the API at every level.

The lzma matcher runs at B = 4096 (_make_matcher) and once at the tier's
64 KiB blocks (elect_sequences and the stream, one JAX compile). Tolerance:
exact equality.

The JAX package is imported inside fixtures, so the card-only test (the
two device tiers on the card) also runs where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_bzip2_lzma.py
"""

import bz2
import functools
import lzma
import random

import numpy as np
import pytest
import torch

import aocl_compression_tpu_torch as act
from aocl_compression_tpu_torch.codecs import zlib_bzip2_lzma as tcodecs
from aocl_compression_tpu_torch.ops import bwt_device as TB
from aocl_compression_tpu_torch.ops import lz4_device as tlz
from aocl_compression_tpu_torch.ops import lzma_assist as TL
from aocl_compression_tpu_torch.utils import dispatch


def _text(n: int, seed: int = 0) -> bytes:
    rng = random.Random(seed)
    words = [b"candidate ", b"range ", b"coder ", b"sequence ", b"elected ",
             b"block ", b"sort "]
    out = bytearray()
    while len(out) < n:
        out += rng.choice(words)
        if rng.random() < 0.03:
            out += bytes(rng.randrange(256) for _ in range(rng.randrange(9)))
    return bytes(out[:n])


def _mixed(n: int, seed: int = 0) -> bytes:
    """n bytes: text, a random quarter, then a run of 300 bytes."""
    rnd = np.random.default_rng(seed).integers(0, 256, n // 4, np.uint8)
    return _text(n - n // 4 - 300, seed) + rnd.tobytes() + b"z" * 300


# just over the 4,096-byte device threshold
SMALL = _mixed(5000, 1)


def _naive_bwt(s: bytes):
    n = len(s)
    rots = sorted(range(n), key=lambda i: (s[i:] + s[:i]))
    return bytes(s[(i - 1) % n] for i in rots), rots.index(0)


BWT_CASES = [b"banana", b"abracadabra", b"abab", b"aaaa", b"x",
             (b"the quick brown fox " * 13)[:256], _text(700, 3),
             bytes(random.Random(4).randrange(256) for _ in range(512)),
             (b"ab" * 300) + b"c", (b"compression " * 100)[:1024]]


@pytest.fixture(scope="module")
def jbwt():
    from aocl_compression_tpu.ops import bwt_device
    return bwt_device


@pytest.fixture(scope="module")
def jlz():
    from aocl_compression_tpu.ops import lz4_device
    return lz4_device


@pytest.fixture
def device_tier(monkeypatch):
    monkeypatch.setenv("AOCL_ENABLE_INSTRUCTIONS", "XLA")


@pytest.mark.parametrize("i", range(len(BWT_CASES)))
def test_bwt_forward_and_inverse_match_jax(jbwt, i):
    s = BWT_CASES[i]
    L, I = TB.bwt(s, "cpu")
    assert (L, I) == jbwt.bwt(s) == _naive_bwt(s)
    assert TB.ibwt(L, I, "cpu") == jbwt.ibwt(L, I) == s


def test_bwt_block_limit():
    with pytest.raises(ValueError):
        TB.bwt_forward_block(torch.zeros(TB.MAX_BLOCK + 1, dtype=torch.uint8),
                             TB.MAX_BLOCK + 1)


@functools.lru_cache(maxsize=None)
def _candidates(B: int = 4096):
    """Two blocks (a full one and a short one) and the port's matcher
    candidates at depth 16 (tests/test_torch_lz4_device.py holds
    _find_matches to the JAX package's)."""
    data = _mixed(B + 1500, 2)
    arr = np.zeros((2, B), np.uint8)
    arr[0] = np.frombuffer(data[:B], np.uint8)
    arr[1, :1500] = np.frombuffer(data[B:], np.uint8)
    lens = np.array([B, 1500], np.int32)
    cand = tlz._find_matches(torch.from_numpy(arr), torch.from_numpy(lens),
                             B, depth=16)
    return arr, lens, tuple(c.numpy() for c in cand)


def test_grid_parse_g1_matches_jax(jlz):
    """_grid_parse at G = 1 (M = B tiles, 32 chain-marking matrices of
    128 x 128 per block here) against the JAX package's own body."""
    import jax
    import jax.numpy as jnp
    B = 4096
    MAXSEQ = B // 4 + 2
    _, _, (mlen, moff, valid) = _candidates(B)
    ref = jax.jit(jax.vmap(lambda m, o, v: jlz._grid_parse(
        m, o, v, B, 1, MAXSEQ, match_cap=68)))(
            jnp.asarray(mlen), jnp.asarray(moff), jnp.asarray(valid))
    got = tlz._grid_parse(*(torch.from_numpy(c) for c in (mlen, moff,
                                                           valid)),
                          B, 1, MAXSEQ, match_cap=68)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[3][0]) > 100


def test_matcher_b4096_matches_jax():
    from aocl_compression_tpu.ops import lzma_assist
    import jax.numpy as jnp
    arr, lens, _ = _candidates(4096)
    ref = lzma_assist._make_matcher(4096, 1, 16, 68)(jnp.asarray(arr),
                                                     jnp.asarray(lens))
    stages = []
    got = TL._make_matcher(4096, 1, 16, 68)(
        torch.from_numpy(arr), torch.from_numpy(lens), stages.append)
    assert stages == ["find_matches", "grid_parse"]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_lzma_assist_stream_matches_jax(device_tier):
    """elect_sequences and the stream at the tier's 64 KiB blocks, on an
    input just over the device threshold; lzma_compress_torch through the
    API gives the JAX package's lzma_compress_xla stream."""
    from aocl_compression_tpu.ops import lzma_assist
    import aocl_compression_tpu as actpu
    got = TL.elect_sequences(SMALL, G=1, depth=16, device="cpu")
    ref = lzma_assist.elect_sequences(SMALL, G=1, depth=16)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert len(got[0]) > 50
    c = TL.compress(SMALL, 6, device="cpu")
    assert c == lzma_assist.compress(SMALL, 6)
    h = act.setup("lzma", level=6, opt_var=2, device="cpu")
    dispatch.enable_audit(True)
    try:
        assert act.compress(h, SMALL) == c
        assert dispatch.audit_hits() == {"lzma_compress_torch": 1}
    finally:
        dispatch.enable_audit(False)
    assert c == actpu.compress(actpu.setup("lzma", level=6, opt_var=2),
                               SMALL)
    assert lzma.decompress(c, format=lzma.FORMAT_ALONE) == SMALL
    assert act.decompress(h, c) == SMALL


@pytest.mark.parametrize("level,n", [(9, 5000), (1, 230000)])
def test_bzip2_device_stream_matches_jax(device_tier, level, n):
    """bzip2_compress_torch against the JAX package's bzip2_compress_xla:
    one block just over the device threshold, and at level 1 three blocks
    (the third short)."""
    import aocl_compression_tpu as actpu
    data = SMALL if n == 5000 else _text(n, 5)
    h = act.setup("bzip2", level=level, opt_var=2, device="cpu")
    dispatch.enable_audit(True)
    try:
        c = act.compress(h, data)
        assert dispatch.audit_hits() == {"bzip2_compress_torch": 1}
    finally:
        dispatch.enable_audit(False)
    assert c == actpu.compress(actpu.setup("bzip2", level=level,
                                           opt_var=2), data)
    assert bz2.decompress(c) == data
    assert act.decompress(h, c) == data


def test_device_tiers_route_small_inputs_to_host(device_tier):
    data = SMALL[:4000]
    for method, name in (("bzip2", "bzip2_compress_host"),
                         ("lzma", "lzma_compress_host")):
        h = act.setup(method, opt_var=2, device="cpu")
        dispatch.enable_audit(True)
        try:
            c = act.compress(h, data)
            hits = dispatch.audit_hits()
        finally:
            dispatch.enable_audit(False)
        assert hits == {f"{method}_compress_torch": 1, name: 1}
        assert act.decompress(h, c) == data


@pytest.mark.parametrize("level", range(1, 10))
def test_bzip2_host_tier_stream_matches_jax(level):
    """The host tier at every level, with the host fan-out into
    concatenated streams at level 1 (input > 2 blocks)."""
    import aocl_compression_tpu as actpu
    data = _mixed(210000 if level == 1 else 20000, level)
    h = act.setup("bzip2", level=level, device="cpu")
    c = act.compress(h, data)
    assert c == actpu.compress(actpu.setup("bzip2", level=level), data)
    assert bz2.decompress(c) == data
    assert act.decompress(h, c) == data
    assert act.decompress(h, c, expected_size=len(data)) == data


@pytest.mark.parametrize("level", range(0, 10))
def test_lzma_host_tier_stream_matches_jax(level):
    import aocl_compression_tpu as actpu
    data = _mixed(20000, level)
    h = act.setup("lzma", level=level, device="cpu")
    c = act.compress(h, data)
    assert c == actpu.compress(actpu.setup("lzma", level=level), data)
    assert lzma.decompress(c, format=lzma.FORMAT_ALONE) == data
    assert act.decompress(h, c) == data
    assert act.decompress(h, c, expected_size=len(data)) == data


def test_codec_surface_matches_jax():
    import aocl_compression_tpu as actpu
    for method in ("bzip2", "lzma"):
        t, j = act.get_codec(method), actpu.get_codec(method)
        assert (t.min_level, t.max_level, t.default_level, t.version) == (
            j.min_level, j.max_level, j.default_level, j.version)
        assert act.compress_bound(method, 1 << 20) == actpu.compress_bound(
            method, 1 << 20)
    with pytest.raises(ValueError):
        tcodecs._bzip2_decompress_host(b"BZh9garbage")
    with pytest.raises(ValueError):
        tcodecs._lzma_decompress_host(b"\x5d\x00\x00garbage")


# --- card-only: the device tiers on the card -----------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_tiers_on_card(cuda_device):
    data = _mixed(300000, 6)
    for method in ("bzip2", "lzma"):
        h = act.setup(method, opt_var=2, device=cuda_device)
        c = act.compress(h, data)
        assert c == act.compress(act.setup(method, opt_var=2, device="cpu"),
                                 data)
        assert act.decompress(h, c) == data
