"""Parity of the port's deflate encoders (zlib levels 1 and 2) with the JAX
package's.

The same inputs go through each JAX function (jitted and vmapped on the
CPU) and its counterpart in aocl_compression_tpu_torch on device="cpu";
the tolerance is exact equality. The symbol tables are held over their
whole domains, the emitters and the code construction stage by stage, the
host-facing encoders chunk for chunk (stdlib zlib decodes them), including
an empty block, whose one-symbol litlen code fails the Kraft fixup and
takes the static fallback.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aocl_compression_tpu.ops import deflate_device as jdev
from aocl_compression_tpu.ops import lz4_device as jlz
from aocl_compression_tpu_torch.codecs import zlib_bzip2_lzma as tzlib
from aocl_compression_tpu_torch.ops import deflate_device as tdev
from test_torch_lz4_device import KINDS, _batch, _payload

B = 1024
BLOCKS = ([_payload(k, B, s) for s, k in enumerate(KINDS)]
          + [bytes(144 + (i * 37) % 112 for i in range(B)),  # 9-bit codes
             _payload("text", 333, 9)])
GRIDS = [0, 4]


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _inflate(chunks):
    return zlib.decompressobj(-15).decompress(b"".join(chunks)
                                              + tdev.FINAL_BLOCK)


# --- symbol tables over their whole domains ----------------------------------

def test_len_sym_domain():
    lens = np.arange(3, 259, dtype=np.int32)
    ref = jax.jit(jdev._len_sym)(jnp.asarray(lens))
    for port, r in zip(tdev._len_sym(_t(lens)), ref):
        _eq(port, r)
    ref = jax.jit(jdev._len_code_idx)(jnp.asarray(lens))
    for port, r in zip(tdev._len_code_idx(_t(lens)), ref):
        _eq(port, r)


def test_dist_sym_domain():
    dists = np.arange(1, 32769, dtype=np.int32)
    ref = jax.jit(jdev._dist_sym)(jnp.asarray(dists))
    for port, r in zip(tdev._dist_sym(_t(dists)), ref):
        _eq(port, r)
    ref = jax.jit(jdev._dist_code_idx)(jnp.asarray(dists))
    for port, r in zip(tdev._dist_code_idx(_t(dists)), ref):
        _eq(port, r)


@pytest.mark.parametrize("width", [5, 9, 15])
def test_rev_bits_domain(width):
    v = np.repeat(np.arange(1 << width, dtype=np.int32), width + 1)
    n = np.tile(np.arange(width + 1, dtype=np.int32), 1 << width)
    ref = jax.jit(functools.partial(jdev._rev_bits, width=width))(
        jnp.asarray(v), jnp.asarray(n))
    _eq(tdev._rev_bits(_t(v), _t(n), width), ref)
    b = np.arange(256, dtype=np.int32)
    for port, r in zip(tdev._lit_code(_t(b)),
                       jax.jit(jdev._lit_code)(jnp.asarray(b))):
        _eq(port, r)


# --- code construction -------------------------------------------------------

def _hists(nsym, seed):
    """Histograms of real blocks' shapes and of the edges: empty, one
    symbol, two symbols, counts past 2^16 (the int32 product wraps in the
    JAX package), skewed and flat rows."""
    rng = np.random.default_rng(seed)
    rows = [np.zeros(nsym), np.eye(nsym)[3] * 5, np.eye(nsym)[0] + np.eye(
        nsym)[nsym - 1] * 9]
    big = np.zeros(nsym)
    big[[1, 7, nsym - 2]] = [70000, 3, 1]
    rows.append(big)
    for _ in range(12):
        k = rng.integers(2, nsym)
        h = np.zeros(nsym)
        h[rng.choice(nsym, k, replace=False)] = rng.integers(
            1, 4000, k) ** rng.integers(1, 3)
        rows.append(h)
    rows.append(np.full(nsym, 250))
    return np.array(rows, np.int32)


@pytest.mark.parametrize("nsym", [288, 32])
def test_kraft_lengths(nsym):
    hist = _hists(nsym, nsym)
    jnb, jok = (np.asarray(x) for x in jax.jit(jax.vmap(functools.partial(
        jdev._kraft_lengths, NSYM=nsym)))(jnp.asarray(hist)))
    nb, ok = tdev._kraft_lengths(_t(hist), nsym)
    _eq(nb, jnb)
    _eq(ok, jok)
    assert not ok[0] and not ok[1] and ok[2:].all()


@pytest.mark.parametrize("nsym", [288, 32])
def test_canonical_codes(nsym):
    hist = _hists(nsym, nsym + 1)
    nb = tdev._kraft_lengths(_t(hist), nsym)[0]
    ref = jax.jit(jax.vmap(functools.partial(jdev._canonical_codes,
                                             NSYM=nsym)))(
        jnp.asarray(nb.numpy()))
    _eq(tdev._canonical_codes(nb, nsym), ref)


# --- emitters and encoders ---------------------------------------------------

def _sizes(G):
    MAXSEQ = B // max(G, jlz.MIN_MATCH) + 2
    return jdev.out_capacity(B), MAXSEQ, MAXSEQ + B // 255 + 2


@functools.lru_cache(maxsize=None)
def _jax_parse(G):
    """(pos, ml, off, nseq) of the JAX parse for BLOCKS, as the encoders
    make it (32 KiB window)."""
    _, MAXSEQ, _ = _sizes(G)

    def per_block(data, n):
        mlen, moff, valid = jlz._find_matches(data, n, B, max_off=32768)
        if G:
            return jlz._grid_parse(mlen, moff, valid, B, G, MAXSEQ,
                                   match_cap=68)
        mark = jlz._greedy_parse(mlen, valid, B)
        return jlz._select_sequences(mark, valid, mlen, moff, B, MAXSEQ)

    arr, lens = _batch(BLOCKS)
    return [np.asarray(x) for x in jax.jit(jax.vmap(per_block))(
        jnp.asarray(arr), jnp.asarray(lens))]


@pytest.mark.parametrize("G", GRIDS)
def test_emit_deflate(G):
    OUTCAP, MAXSEQ, MAXPIECE = _sizes(G)
    arr, lens = _batch(BLOCKS)
    seqs = _jax_parse(G)
    fn = functools.partial(jdev._emit_deflate, B=B, OUTCAP=OUTCAP,
                           MAXSEQ=MAXSEQ, MAXPIECE=MAXPIECE)
    jo, js = (np.asarray(x) for x in jax.jit(jax.vmap(fn))(
        jnp.asarray(arr), *map(jnp.asarray, seqs), jnp.asarray(lens)))
    o, s = tdev._emit_deflate(_t(arr), *map(_t, seqs), _t(lens), B, OUTCAP,
                              MAXSEQ, MAXPIECE)
    _eq(o, jo)
    _eq(s, js)


@pytest.mark.parametrize("G", GRIDS)
def test_emit_deflate_dyn(G):
    OUTCAP, MAXSEQ, MAXPIECE = _sizes(G)
    arr, lens = _batch(BLOCKS)
    seqs = _jax_parse(G)
    fn = functools.partial(jdev._emit_deflate_dyn, B=B, OUTCAP=OUTCAP,
                           MAXSEQ=MAXSEQ, MAXPIECE=MAXPIECE)
    ref = jax.jit(jax.vmap(fn))(jnp.asarray(arr), *map(jnp.asarray, seqs),
                                jnp.asarray(lens))
    got = tdev._emit_deflate_dyn(_t(arr), *map(_t, seqs), _t(lens), B,
                                 OUTCAP, MAXSEQ, MAXPIECE)
    for port, r in zip(got, ref):
        _eq(port, r)


@pytest.mark.parametrize("G", GRIDS)
@pytest.mark.parametrize("dyn", [False, True], ids=["static", "dynamic"])
def test_make_encoder(G, dyn):
    arr, lens = _batch(BLOCKS)
    make_j, make_t = ((jdev.make_encoder_dyn, tdev.make_encoder_dyn) if dyn
                      else (jdev.make_encoder, tdev.make_encoder))
    ref = make_j(B, G)(jnp.asarray(arr), jnp.asarray(lens))
    got = make_t(B, G)(_t(arr), _t(lens))
    assert got[1].dtype == torch.int32
    for port, r in zip(got, ref):
        _eq(port, r)


@pytest.mark.parametrize("accel", [1, 2])
def test_encode_blocks(accel):
    chunks = tdev.encode_blocks(BLOCKS, accel, device="cpu")
    assert chunks == jdev.encode_blocks(BLOCKS, accel)[0]
    for c, b in zip(chunks, BLOCKS):
        assert zlib.decompressobj(-15).decompress(c) == b
    assert _inflate(chunks) == b"".join(BLOCKS)


@pytest.mark.parametrize("accel", [1, 2])
def test_encode_blocks_dyn(accel):
    chunks, failed = tdev.encode_blocks_dyn(BLOCKS, accel, device="cpu")
    assert failed == []
    assert chunks == jdev.encode_blocks_dyn(BLOCKS, accel)[0]
    assert all((c[0] >> 1) & 3 == 2 for c in chunks)   # BTYPE = dynamic
    assert _inflate(chunks) == b"".join(BLOCKS)


def test_encode_blocks_dyn_kraft_fallback():
    """An empty block's litlen code has one symbol (EOB): its Kraft fixup
    fails, the device batch returns it as None, and the codec tier's
    static re-encode gives the JAX package's chunk."""
    blocks = [BLOCKS[0], b"", BLOCKS[3]]
    chunks, failed = tdev.encode_blocks_dyn(blocks, 2, device="cpu")
    assert failed == [1] and chunks[1] is None
    jchunks = jdev.encode_blocks_dyn(blocks, 2)[0]
    got = tzlib._device_chunks(blocks, 2, "cpu")
    assert got == jchunks
    assert (got[1][0] >> 1) & 3 == 1                     # BTYPE = static
    assert _inflate(got) == b"".join(blocks)


def test_single_block_batches():
    """One block per batch (the single-shot path's short inputs and the
    static fallback): the rows are cut from a wider buffer."""
    b = BLOCKS[2][:700]
    assert tdev.encode_blocks([b], 2, device="cpu") == \
        jdev.encode_blocks([b], 2)[0]
    assert tdev.encode_blocks_dyn([b], 2, device="cpu")[0] == \
        jdev.encode_blocks_dyn([b], 2)[0]


def test_host_header_helpers():
    """The host side of the dynamic path is the JAX package's code."""
    nb = tdev._kraft_lengths(_t(_hists(288, 5)), 288)[0].numpy()
    nd = tdev._kraft_lengths(_t(_hists(32, 6)), 32)[0].numpy()
    for i in range(2, len(nb)):
        assert tdev._dyn_header(nb[i], nd[i % len(nd)]) == \
            jdev._dyn_header(nb[i], nd[i % len(nd)])
    assert tdev.out_capacity(65536) == jdev.out_capacity(65536) == 74240


@pytest.mark.parametrize("dyn", [False, True], ids=["static", "dynamic"])
def test_encode_blocks_full_blocks(dyn):
    """64 KiB blocks, the size the zlib device tier uses: the same chunks
    as the JAX package, read by stdlib zlib."""
    blocks = [_payload("text", 65536, 1), _payload("mixed", 65536, 2)]
    if dyn:
        chunks = tdev.encode_blocks_dyn(blocks, 2, device="cpu")[0]
        ref = jdev.encode_blocks_dyn(blocks, 2)[0]
    else:
        chunks = tdev.encode_blocks(blocks, 2, device="cpu")
        ref = jdev.encode_blocks(blocks, 2)[0]
    assert chunks == ref
    assert _inflate(chunks) == b"".join(blocks)
