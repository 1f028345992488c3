"""Parity of the port's LZ4 device decoder with the JAX package's.

The same chunk batches go through each JAX decoder stage (jitted and
vmapped on the CPU, as tests/test_device_lz4.py runs them) and its
counterpart in aocl_compression_tpu_torch on device="cpu"; the tolerance
is exact equality. The chunks are RAP chunk regions, as the codecs hand
them to the decoder: stitched from the exact-parse encoder (the lz4hc
device tier at level 9), from the sort-emit encoder (the lz4 device tier)
and from the host C++ encoder, for the payload kinds of
tests/test_torch_lz4_device.py at B = 1024 and a short block.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aocl_compression_tpu.ops import lz4_device as jdev
from aocl_compression_tpu_torch.codecs import lz4_stitch
from aocl_compression_tpu_torch.codecs.lz4hc import device_params
from aocl_compression_tpu_torch.ops import lz4_device as tdev
from aocl_compression_tpu_torch.runtime import native
from test_torch_lz4_device import KINDS, _payload

B = 1024
BLOCKS = ([_payload(k, B, s) for s, k in enumerate(KINDS)]
          + [_payload("text", 333, 9)])
SOURCES = ["lz4hc", "lz4", "host"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@functools.lru_cache(maxsize=None)
def _stream(source):
    """(chunks, dlens) of BLOCKS, stitched as the RAP container holds them."""
    if source == "host":
        return lz4_stitch.stitch([native.lz4_compress_tail(b) for b in BLOCKS],
                                 BLOCKS)
    if source == "lz4hc":
        bodies, tails, _ = tdev.encode_blocks(BLOCKS, 1, *device_params(9),
                                              device="cpu")
    else:
        bodies, tails, _ = tdev.encode_blocks(BLOCKS, 2, device="cpu")
    return lz4_stitch.stitch_bodies(bodies, tails, BLOCKS)


def _padded(chunks, dlens):
    """The batch decode_blocks builds: (arr (N, C), clens, dlens, C, Bd)."""
    C = jdev._bucket(max(len(c) for c in chunks))
    Bd = jdev._bucket(max(max(dlens), B))
    arr = np.zeros((len(chunks), C), np.uint8)
    for i, c in enumerate(chunks):
        arr[i, :len(c)] = np.frombuffer(c, np.uint8)
    clens = np.array([len(c) for c in chunks], np.int32)
    return arr, clens, np.asarray(dlens, np.int32), C, Bd


def _jax_stages(C, Bd):
    def per_chunk(chunk, clen, dlen):
        nxt, produced, lit, a, offs = jdev._token_scan(chunk, clen, C)
        mark = jdev._chain_marks(nxt, clen, C)
        out = jdev._decode_block(chunk, clen, dlen, C, Bd, C // 3 + 2)
        return nxt, produced, lit, a, offs, mark, out

    return jax.jit(jax.vmap(per_chunk))


@functools.lru_cache(maxsize=None)
def _ref(source):
    arr, clens, dlens, C, Bd = _padded(*_stream(source))
    res = _jax_stages(C, Bd)(jnp.asarray(arr), jnp.asarray(clens),
                             jnp.asarray(dlens))
    return [np.asarray(x) for x in res]


@pytest.mark.parametrize("source", SOURCES)
def test_token_scan(source):
    arr, clens, _, C, _ = _padded(*_stream(source))
    got = tdev._token_scan(_t(arr), _t(clens), C)
    for port, r in zip(got, _ref(source)[:5]):
        _eq(port, r)


@pytest.mark.parametrize("source", SOURCES)
def test_chain_marks(source):
    _, clens, _, C, _ = _padded(*_stream(source))
    nxt = _ref(source)[0]
    _eq(tdev._chain_marks(_t(nxt), _t(clens), C), _ref(source)[5])


@pytest.mark.parametrize("source", SOURCES)
def test_decode_block(source):
    chunks, dlens = _stream(source)
    arr, clens, dl, C, Bd = _padded(chunks, dlens)
    out = tdev.make_decoder(C, Bd)(_t(arr), _t(clens), _t(dl))
    _eq(out, _ref(source)[6])
    total = b"".join(BLOCKS)
    assert b"".join(out[i, :d].numpy().tobytes()
                    for i, d in enumerate(dlens)) == total


@pytest.mark.parametrize("source", SOURCES)
def test_decode_blocks(source):
    """The host-facing batch decode, through the compaction (B % 512 == 0),
    returns each chunk's bytes, as the JAX package's decode_blocks."""
    chunks, dlens = _stream(source)
    got = tdev.decode_blocks(chunks, dlens, B, device="cpu")
    assert got == jdev.decode_blocks(chunks, dlens, B)
    pos = 0
    total = b"".join(BLOCKS)
    for g, d in zip(got, dlens):
        assert g == total[pos:pos + d]
        pos += d


def test_resolve_passes():
    """The resolve loop ends after at most log2(B) + 1 passes, with every
    entry a literal source."""
    arr, clens, dl, C, Bd = _padded(*_stream("lz4hc"))
    src = tdev._decode_sources(_t(arr), _t(clens), _t(dl), C, Bd)
    res, passes = tdev._resolve(src)
    assert bool((res < 0).all()) and 1 <= passes <= Bd.bit_length()


def _long_literal_chunk() -> bytes:
    """A host-made chunk of > 4 KiB (C = 8192) whose random stretch makes
    literal runs longer than one 128-byte segment."""
    rng = np.random.default_rng(21)
    data = (_payload("text", 3000, 4) + rng.integers(0, 256, 5000,
                                                     dtype=np.uint8).tobytes()
            + _payload("periodic", 1500) + _payload("text", 1000, 5))
    return native.lz4_compress(data), data


def test_chain_marks_segments_without_entry():
    chunk, data = _long_literal_chunk()
    arr, clens, dl, C, Bd = _padded([chunk], [len(data)])
    assert C >= 8192

    def per_chunk(chunk, clen):
        nxt = jdev._token_scan(chunk, clen, C)[0]
        return nxt, jdev._chain_marks(nxt, clen, C)

    nxt, want = (np.asarray(x) for x in jax.jit(jax.vmap(per_chunk))(
        jnp.asarray(arr), jnp.asarray(clens)))
    # segments inside the chunk with no mark: the chain jumped past them
    seg_marked = want[0, :C].reshape(-1, tdev.SEG).any(axis=1)
    assert not seg_marked[:int(clens[0]) // tdev.SEG].all()
    _eq(tdev._chain_marks(_t(nxt), _t(clens), C), want)
    got = tdev.decode_blocks([chunk], [len(data)], len(data), device="cpu")
    assert got == [data]


def test_decode_blocks_limits():
    assert tdev.decode_blocks([], [], B, device="cpu") == []
    with pytest.raises(ValueError):
        tdev.decode_blocks([b"\x00"], [tdev.MAX_DEVICE_BLOCK + 1], B,
                           device="cpu")


def test_host_decoder_buffer_has_slack(monkeypatch):
    """A valid chunk ending in a long literal run and a short match: the
    shared library's fast path writes 20 bytes for the 4-byte match, 16
    past the output's end, so the port's binding allocates slack past the
    expected size and still returns exactly the decoded bytes."""
    rng = np.random.default_rng(3)
    lits = rng.integers(0, 256, 100, dtype=np.uint8).tobytes()
    chunk = bytes([0xF0, 100 - 15]) + lits + (50).to_bytes(2, "little")
    caps = []
    alloc = native._alloc_out
    monkeypatch.setattr(native, "_alloc_out",
                        lambda cap: caps.append(cap) or alloc(cap))
    assert native.lz4_decompress(chunk, 104) == lits + lits[50:54]
    assert caps == [104 + native._DECODE_SLACK]
    assert native._DECODE_SLACK >= 16
