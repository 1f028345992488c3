"""Parity of the port's snappy encoder and decoder with the JAX package's.

The same inputs go through each JAX stage (jitted and vmapped on the CPU)
and its counterpart in aocl_compression_tpu_torch on device="cpu"; both
pipelines are integer-only with unique sort keys, so the tolerance is exact
equality. The encoder is held at the tile grids G = 4 and 8 (the
sort-emit path, accel 2 and 3) and G = 0 (the exact parse, accel 1), the
decoder on chunks made by both device encoders and by the host encoder.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aocl_compression_tpu.ops import lz4_device as jlz
from aocl_compression_tpu.ops import snappy_device as jdev
from aocl_compression_tpu_torch.codecs import snappy as tsnappy
from aocl_compression_tpu_torch.ops import snappy_device as tdev
from aocl_compression_tpu_torch.runtime import native
from test_torch_lz4_device import KINDS, _batch, _payload

B = 1024
BLOCKS = ([_payload(k, B, s) for s, k in enumerate(KINDS)]
          + [_payload("text", 333, 9)])
GRIDS = [0, 4, 8]
ACCEL = {0: 1, 4: 2, 8: 3}


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _flagged_block() -> bytes:
    """256 distinct bytes and filler, then a tile-aligned 4-byte match
    pair: a > 256-byte literal run closed by a minimum-length match, whose
    headers need more bytes than the match has spares (the construction
    of tests/test_device_snappy.py)."""
    rng = random.Random(7)
    pre = bytes(np.random.default_rng(0).permutation(
        np.arange(256, dtype=np.uint8))) + bytes(
        rng.randrange(256) for _ in range(50))
    blk = bytearray(pre)
    blk += b"wxyz" + b"\x00"
    blk += b"wxyz" + b"\xff"
    blk += bytes(rng.randrange(256) for _ in range(32))
    return bytes(blk)


@functools.lru_cache(maxsize=None)
def _jax_stages(G):
    """Every stage's output of the JAX encoder at grid G, for BLOCKS."""
    OUTCAP = jdev.out_capacity(B)
    MAXSEQ = B // max(G, jlz.MIN_MATCH) + 2

    def tile(data, n):
        mlen, moff, valid = jlz._find_matches(data, n, B, depth=4, nw=8)
        sel, cpos, cml, coff = jlz._grid_select(mlen, moff, valid, B, G,
                                                subm=128, match_cap=36)
        return (sel, cpos, cml, coff) + jdev._emit_snappy_sorted(
            data, n, sel, cpos, cml, coff, B, G)

    def exact(data, n):
        mlen, moff, valid = jlz._find_matches(data, n, B)
        mark = jlz._greedy_parse(mlen, valid, B)
        pos, ml, off, nseq = jlz._select_sequences(mark, valid, mlen, moff,
                                                   B, MAXSEQ)
        return (pos, ml, off, nseq) + jdev._emit_snappy(
            data, pos, ml, off, nseq, n, B, OUTCAP, MAXSEQ)

    arr, lens = _batch(BLOCKS)
    fn = jax.jit(jax.vmap(tile if G else exact))
    return [np.asarray(x) for x in fn(jnp.asarray(arr), jnp.asarray(lens))]


@pytest.mark.parametrize("G", [4, 8])
def test_emit_snappy_sorted(G):
    arr, lens = _batch(BLOCKS)
    sel, cpos, cml, coff, out, body, tail, flag = _jax_stages(G)
    o, b, t, f = tdev._emit_snappy_sorted(_t(arr), _t(lens), _t(sel),
                                          _t(cpos), _t(cml), _t(coff), B, G)
    _eq(b, body)
    _eq(t, tail)
    _eq(f, flag)
    for i in range(len(BLOCKS)):
        np.testing.assert_array_equal(o[i, :body[i]].numpy(),
                                      out[i, :body[i]])


def test_emit_snappy():
    """The exact encoder's serializer, including the trailing literal
    element written in place: every byte of the OUTCAP rows."""
    arr, lens = _batch(BLOCKS)
    pos, ml, off, nseq, out, size, tail = _jax_stages(0)
    MAXSEQ = B // jlz.MIN_MATCH + 2
    o, s, t = tdev._emit_snappy(_t(arr), _t(pos), _t(ml), _t(off), _t(nseq),
                                _t(lens), B, tdev.out_capacity(B), MAXSEQ)
    _eq(o, out)
    _eq(s, size)
    _eq(t, tail)


@pytest.mark.parametrize("G", GRIDS)
def test_make_encoder(G):
    arr, lens = _batch(BLOCKS)
    jo, js, jt, jf = (np.asarray(x) for x in jdev.make_encoder(B, G)(
        jnp.asarray(arr), jnp.asarray(lens)))
    to, ts, tt, tf = tdev.make_encoder(B, G)(_t(arr), _t(lens))
    assert to.shape == jo.shape and to.dtype == torch.uint8
    assert ts.dtype == torch.int32
    _eq(ts, js)
    _eq(tt, jt)
    _eq(tf, jf)
    for i in range(len(BLOCKS)):
        np.testing.assert_array_equal(to[i, :js[i]].numpy(), jo[i, :js[i]])


@pytest.mark.parametrize("G", GRIDS)
def test_encode_blocks(G):
    """The host-facing batch encode (compaction, tails appended) gives the
    JAX package's fragments; the host decoder reads each one and their
    concatenation."""
    frags, flagged = tdev.encode_blocks(BLOCKS, ACCEL[G], device="cpu")
    jfrags, dlens = jdev.encode_blocks(BLOCKS, ACCEL[G])
    assert flagged == [] and frags == jfrags
    for f, b in zip(frags, BLOCKS):
        assert native.snappy_uncompress(tsnappy._varint(len(b)) + f) == b
    total = b"".join(BLOCKS)
    assert native.snappy_uncompress(tsnappy._varint(len(total))
                                    + b"".join(frags)) == total


def test_encode_blocks_flagged():
    """A block the sort-emit encoder cannot serialize comes back as None
    and flagged; after the codec tier's host re-encode the fragments are
    the JAX package's."""
    blocks = [_flagged_block(), BLOCKS[0], BLOCKS[4]]
    arr, lens = _batch(blocks)
    jflags = np.asarray(jdev.make_encoder(B, 4)(jnp.asarray(arr),
                                                jnp.asarray(lens))[3])
    assert jflags.tolist() == [True, False, False]
    frags, flagged = tdev.encode_blocks(blocks, 2, device="cpu")
    assert flagged == [0] and frags[0] is None
    jfrags, _ = jdev.encode_blocks(blocks, 2)
    assert tsnappy._device_frags(blocks, 2, "cpu") == jfrags
    assert frags[1:] == jfrags[1:]


def test_long_matches_split_like_reference():
    """Runs force the EmitCopy split (64-byte copies, the 60-byte copy,
    the final copy) in the exact encoder, and the 2-byte literal header."""
    blocks = [b"x" * n + b"tail of literals" for n in
              (64, 65, 67, 68, 131, 132, 200, 1000)]
    blocks.append(bytes(random.Random(3).randrange(256) for _ in range(300))
                  + b"y" * 200)
    frags, _ = tdev.encode_blocks(blocks, 1, device="cpu")
    assert frags == jdev.encode_blocks(blocks, 1)[0]
    for f, b in zip(frags, blocks):
        assert native.snappy_uncompress(tsnappy._varint(len(b)) + f) == b


# --- decoder -----------------------------------------------------------------

SOURCES = ["tile", "exact", "host"]


@functools.lru_cache(maxsize=None)
def _chunks(source):
    if source == "host":
        return [tsnappy._strip_preamble(native.snappy_compress(b))
                for b in BLOCKS]
    return tdev.encode_blocks(BLOCKS, 2 if source == "tile" else 1,
                              device="cpu")[0]


def _padded(chunks):
    C = jlz._bucket(max(len(c) for c in chunks))
    arr = np.zeros((len(chunks), C), np.uint8)
    for i, c in enumerate(chunks):
        arr[i, :len(c)] = np.frombuffer(c, np.uint8)
    clens = np.array([len(c) for c in chunks], np.int32)
    dlens = np.array([len(b) for b in BLOCKS], np.int32)
    return arr, clens, dlens, C


@functools.lru_cache(maxsize=None)
def _jax_decode(source):
    arr, clens, dlens, C = _padded(_chunks(source))

    def per_chunk(chunk, clen, dlen):
        return jdev._tag_scan(chunk, clen, C) + (
            jdev._decode_block(chunk, clen, dlen, C, B),)

    res = jax.jit(jax.vmap(per_chunk))(jnp.asarray(arr), jnp.asarray(clens),
                                       jnp.asarray(dlens))
    return [np.asarray(x) for x in res]


@pytest.mark.parametrize("source", SOURCES)
def test_tag_scan(source):
    arr, clens, _, C = _padded(_chunks(source))
    got = tdev._tag_scan(_t(arr), _t(clens), C)
    for port, ref in zip(got, _jax_decode(source)[:5]):
        _eq(port, ref)


@pytest.mark.parametrize("source", SOURCES)
def test_decode_block(source):
    arr, clens, dlens, C = _padded(_chunks(source))
    out = tdev.make_decoder(C, B)(_t(arr), _t(clens), _t(dlens))
    _eq(out, _jax_decode(source)[5])
    assert [out[i, :d].numpy().tobytes() for i, d in enumerate(dlens)] \
        == BLOCKS


@pytest.mark.parametrize("source", SOURCES)
def test_decode_blocks(source):
    """The host-facing batch decode, through the compaction, returns the
    JAX package's blocks."""
    chunks = _chunks(source)
    dlens = [len(b) for b in BLOCKS]
    got = tdev.decode_blocks(chunks, dlens, B, device="cpu")
    assert got == jdev.decode_blocks(chunks, dlens, B) == BLOCKS


def test_decode_blocks_limits():
    assert tdev.decode_blocks([], [], B, device="cpu") == []
    with pytest.raises(ValueError):
        tdev.decode_blocks([b"\x00"], [jlz.MAX_DEVICE_BLOCK + 1], B,
                           device="cpu")


def test_out_capacity_and_literal_element():
    for n in (1024, 4096, 65536):
        assert tdev.out_capacity(n) == jdev.out_capacity(n)
    assert tdev.out_capacity(65536) == 76800   # 150 rows of 512 B
    for n in (0, 1, 60, 61, 256, 257, 4000):
        lits = bytes(range(256)) * (n // 256 + 1)
        assert tdev.literal_element(lits[:n]) == \
            jdev.literal_element(lits[:n])


@pytest.mark.parametrize("G", [0, 4])
def test_make_encoder_full_blocks(G):
    """64 KiB blocks: positions past 32,767, where the JAX package's int32
    packs wrap and the port's int64 packs do not, give the same bytes."""
    BB = 65536
    blocks = [_payload("text", BB, 1), _payload("mixed", BB, 2)]
    arr = np.stack([np.frombuffer(b, np.uint8) for b in blocks])
    lens = np.full(2, BB, np.int32)
    jo, js, jt, jf = (np.asarray(x) for x in jdev.make_encoder(BB, G)(
        jnp.asarray(arr), jnp.asarray(lens)))
    to, ts, tt, tf = tdev.make_encoder(BB, G)(_t(arr), _t(lens))
    _eq(ts, js)
    _eq(tt, jt)
    _eq(tf, jf)
    for i in range(2):
        np.testing.assert_array_equal(to[i, :js[i]].numpy(), jo[i, :js[i]])
