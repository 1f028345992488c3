"""Parity of the port's exact-parse LZ4 encoder (G = 0, the lz4hc device
tier) and its tile-parse compaction with the JAX package's.

The same numpy inputs go through each JAX stage (jitted and vmapped on the
CPU, as tests/test_device_lz4.py runs them) and its counterpart in
aocl_compression_tpu_torch on device="cpu". Both pipelines are
integer-only with unique sort keys, so the tolerance is exact equality.
Each port stage is fed the JAX stage's inputs, so a difference points at
one stage. The encoder configs are the lz4hc device tier's (depth, nw,
lazy) at levels 1, 4, 9 and 12.
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
from test_torch_lz4_device import KINDS, _batch, _payload

B = 1024
OUTCAP = jdev.out_capacity(B)
MAXSEQ = B // jdev.MIN_MATCH + 2
LEVELS = [1, 4, 9, 12]
BLOCKS = ([_payload(k, B, s) for s, k in enumerate(KINDS)]
          + [_payload("text", 333, 9)])


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _jax_stages(depth, nw, lazy):
    """One jitted, vmapped JAX function returning every stage's output of
    _encode_block at G = 0."""

    def per_block(data, n):
        mlen, moff, valid = jdev._find_matches(data, n, B, depth=depth, nw=nw)
        v = valid
        for _ in range(lazy):  # _encode_block's lazy demotion
            nx_len = jnp.concatenate([mlen[1:], jnp.zeros(1, jnp.int32)])
            nx_val = jnp.concatenate([v[1:], jnp.zeros(1, bool)])
            v = v & ~(nx_val & (nx_len > mlen + 1))
        mark = jdev._greedy_parse(mlen, v, B)
        pos, ml, off, nseq = jdev._select_sequences(mark, v, mlen, moff, B,
                                                    MAXSEQ)
        out, body, tail = jdev._emit(data, pos, ml, off, nseq, n, B, OUTCAP,
                                     MAXSEQ)
        return mlen, moff, valid, v, mark, pos, ml, off, nseq, out, body, tail

    return jax.jit(jax.vmap(per_block))


ARR, LENS = _batch(BLOCKS)


@functools.lru_cache(maxsize=None)
def _ref(level):
    """The JAX stage outputs at an lz4hc level (one compile per level and
    process, so an xdist worker compiles only the levels it runs)."""
    res = _jax_stages(*device_params(level))(jnp.asarray(ARR),
                                             jnp.asarray(LENS))
    return [np.asarray(x) for x in res]


@pytest.mark.parametrize("level", LEVELS)
def test_find_matches_and_lazy(level):
    depth, nw, lazy = device_params(level)
    ref = _ref(level)
    mlen, moff, valid = tdev._find_matches(_t(ARR), _t(LENS), B, depth=depth,
                                           nw=nw)
    for port, r in zip((mlen, moff, valid), ref[:3]):
        _eq(port, r)
    v = valid
    for _ in range(lazy):
        v = tdev._lazy_demote(mlen, v)
    _eq(v, ref[3])


@pytest.mark.parametrize("level", LEVELS)
def test_greedy_parse(level):
    mlen, _, _, v, mark = _ref(level)[:5]
    _eq(tdev._greedy_parse(_t(mlen), _t(v), B), mark)


@pytest.mark.parametrize("level", LEVELS)
def test_select_sequences(level):
    ref = _ref(level)
    mlen, moff, _, v, mark = ref[:5]
    got = tdev._select_sequences(_t(mark), _t(v), _t(mlen), _t(moff), B,
                                 MAXSEQ)
    for port, r in zip(got, ref[5:9]):
        _eq(port, r)


@pytest.mark.parametrize("level", LEVELS)
def test_emit(level):
    pos, ml, off, nseq, out, body, tail = _ref(level)[5:]
    o, b, t = tdev._emit(_t(ARR), _t(pos), _t(ml), _t(off), _t(nseq),
                         _t(LENS), B, OUTCAP, MAXSEQ)
    _eq(b, body)
    _eq(t, tail)
    _eq(o, out)  # bytes past body are 0 in both
    assert o.shape == (len(BLOCKS), OUTCAP) and o.dtype == torch.uint8


@pytest.mark.parametrize("level", LEVELS)
def test_make_encoder_exact(level):
    """make_encoder(B, 0, ...) end to end at the lz4hc level's config:
    rows of out_capacity(B) bytes, no flags; the JAX package's
    make_encoder is vmap(_encode_block), whose stages _ref runs."""
    depth, nw, lazy = device_params(level)
    out, body, tail = _ref(level)[9:]
    to, ts, tt, tf = tdev.make_encoder(B, 0, depth, nw, lazy=lazy)(
        _t(ARR), _t(LENS))
    _eq(ts, body)
    _eq(tt, tail)
    _eq(to, out)
    assert not tf.any()


@pytest.mark.parametrize("level", LEVELS)
def test_encode_blocks_exact(level):
    """encode_blocks at accel 1 (G = 0) through the compaction at OUTCAP =
    out_capacity(B): the JAX encoder's bodies and tails, and a stitched
    stream the serial host decoder reads back."""
    depth, nw, lazy = device_params(level)
    out, body, tail = _ref(level)[9:]
    tb, tt, flagged = tdev.encode_blocks(BLOCKS, 1, depth, nw, lazy,
                                         device="cpu")
    assert flagged == []
    assert tb == [out[i, :body[i]].tobytes() for i in range(len(BLOCKS))]
    assert tt == tail.tolist()
    chunks, dlens = lz4_stitch.stitch_bodies(tb, tt, BLOCKS)
    total = b"".join(BLOCKS)
    assert sum(dlens) == len(total)
    assert native.lz4_decompress(b"".join(chunks), len(total)) == total


# --- the tile parse (G >= 1), compacted: no lz4 path reaches it yet --------

GRID = [(4, 8), (8, 16), (16, 32)]


@pytest.mark.parametrize("G,nw", GRID, ids=[f"G{g}" for g, _ in GRID])
def test_grid_parse(G, nw):
    mlen, moff, _, v = _ref(9)[:4]
    gmax = B // G + 2

    def per_block(mlen, moff, v):
        return jdev._grid_parse(mlen, moff, v, B, G, gmax,
                                match_cap=4 + 4 * nw)

    want = jax.jit(jax.vmap(per_block))(mlen, moff, v)
    got = tdev._grid_parse(_t(mlen), _t(moff), _t(v), B, G, gmax,
                           match_cap=4 + 4 * nw)
    for port, r in zip(got, want):
        _eq(port, r)


@pytest.mark.parametrize("G", [1, 4])
def test_encode_block_tile_parse(G):
    """_encode_block with G >= 1 (the compacted tile parse, then _emit)."""
    maxseq = B // max(G, jdev.MIN_MATCH) + 2

    def per_block(d, n):
        return jdev._encode_block(d, n, B, OUTCAP, maxseq, G=G, depth=4,
                                  nw=16, lazy=1)

    want = jax.jit(jax.vmap(per_block))(jnp.asarray(ARR), jnp.asarray(LENS))
    got = tdev._encode_block(_t(ARR), _t(LENS), B, OUTCAP, maxseq, G=G,
                             depth=4, nw=16, lazy=1)
    for port, r in zip(got, want):
        _eq(port, r)


# --- the shared pieces -------------------------------------------------------

def _fill_case(seed, N=4, K=40, width=300, wide=False):
    """Strictly increasing values at increasing starts, with unused
    entries sent to `width` (dropped), as the callers build them."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(width, (N, K)), axis=1).astype(np.int32)
    starts = np.where(rng.random((N, K)) < 0.2, width, starts)
    # packed: the last values pass 2^31 and stay below 2^32
    step = (rng.integers(1 << 26, 3 << 25, (N, K)) if wide
            else rng.integers(1, 50, (N, K)))
    vals = np.cumsum(step, axis=1).astype(np.int64)
    return starts, vals


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "packed"])
def test_fill(wide):
    """_fill against the JAX _fill; `packed` holds (hi << 16 | lo) values
    past 2^31, which wrap as int32 in JAX (pack + _NEG) and are int64 here."""
    width = 300
    starts, vals = _fill_case(3, width=width, wide=wide)
    assert not wide or vals.max() >= 1 << 31
    init = -(1 << 31) if wide else 0
    # the JAX package's int32 `pack + _NEG` is pack - 2^31 without the wrap
    shifted = vals + init
    want = jax.vmap(lambda v, s: jdev._fill(v, s, width, init))(
        jnp.asarray(shifted.astype(np.int32)), jnp.asarray(starts))
    got = tdev._fill(torch.from_numpy(shifted), torch.from_numpy(starts),
                     width, init)
    _eq(got, np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("maxseq", [8, 40, 70], ids=["drop", "fit", "pad"])
def test_compact_selected(maxseq):
    """More selected than MAXSEQ (the excess is dropped), fewer, and MAXSEQ
    past the domain (padded with the fill values)."""
    rng = np.random.default_rng(5)
    N, DOM = 3, 64
    sel = rng.random((N, DOM)) < 0.4
    order = np.tile(np.arange(DOM, dtype=np.int32), (N, 1))
    pos, ml, off = (rng.integers(0, 1000, (N, DOM)).astype(np.int32)
                    for _ in range(3))
    want = jax.vmap(lambda s, o, p, m, f: jdev._compact_selected(
        s, o, p, m, f, DOM, maxseq))(*(jnp.asarray(x) for x in
                                       (sel, order, pos, ml, off)))
    got = tdev._compact_selected(*(_t(x) for x in (sel, order, pos, ml, off)),
                                 DOM, maxseq)
    for port, r in zip(got, want):
        _eq(port, r)


def test_encoder_widths():
    """G = 0 rows are out_capacity(B) wide (ROWS = 129 at B = 64 KiB, the
    compaction's first row count that is not a power of two)."""
    assert tdev.encoder_block_fn(B, 0)[1] == OUTCAP == jdev.encoder_block_fn(
        B, 0)[1]
    assert tdev.out_capacity(65536) == 66048 == 129 * 512
    assert device_params(9) == (11, 32, 1)
