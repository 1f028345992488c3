"""Parity of the PyTorch sort-emit LZ4 encoder with the JAX package's.

The same numpy inputs go through each JAX stage (jitted on the CPU) and its
counterpart in aocl_compression_tpu_torch on device="cpu". Both pipelines
are integer-only with unique sort keys, so the tolerance is exact equality.
Covers the two encoder configs in use: the API default (G=4, remapped to
depth 4 / nw 8 by encoder_block_fn) and the bench config (G=8, depth 5,
nw 5, subm 64, lazy 1, ext_passes 5).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aocl_compression_tpu.ops import lz4_device as jdev
from aocl_compression_tpu_torch.codecs import lz4 as tlz4
from aocl_compression_tpu_torch.codecs import lz4_stitch
from aocl_compression_tpu_torch.ops import lz4_device as tdev
from aocl_compression_tpu_torch.runtime import native

B = 1024
KINDS = ["text", "rle", "periodic", "random", "mixed"]

# name -> (make_encoder positional args, keyword args); the API default is
# called exactly as encode_blocks calls it, so the JAX encoder is shared
CONFIGS = {
    "api_default": ((B, 4, 2, jdev.NW), dict(lazy=0)),
    "bench": ((B, 8, 5, 5), dict(subm=64, lazy=1, ext_passes=5)),
}


def _payload(kind: str, n: int, seed: int = 0) -> bytes:
    """The payload recipe of tests/test_device_lz4.py."""
    rng = random.Random(seed)
    if kind == "text":
        words = [b"hash ", b"match ", b"the ", b"block ", b"stream "]
        out = bytearray()
        while len(out) < n:
            out += rng.choice(words)
        return bytes(out[:n])
    if kind == "rle":
        return b"a" * n
    if kind == "periodic":
        return (b"abcxyz" * (n // 6 + 1))[:n]
    if kind == "random":
        return bytes(rng.randrange(256) for _ in range(n))
    if kind == "mixed":
        return (_payload("text", n // 2, seed)
                + _payload("random", n - n // 2, seed + 1))
    raise ValueError(kind)


def _far_repeat() -> bytes:
    """A 400-byte repeat far past the hash cap (extension-ladder input)."""
    rng = random.Random(7)
    seg = bytes(rng.randrange(256) for _ in range(400))
    return (seg + _payload("text", 120, 3) + seg + seg)[:B]


def _batch(blocks):
    arr = np.zeros((len(blocks), B), dtype=np.uint8)
    lens = np.zeros(len(blocks), dtype=np.int32)
    for i, b in enumerate(blocks):
        arr[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i] = len(b)
    return arr, lens


BLOCKS = ([_payload(k, B, s) for s, k in enumerate(KINDS)]
          + [_far_repeat(), _payload("text", 333, 9)])


def _resolved(name):
    """(G, depth, nw, subm, lazy, ext_passes) after the G>=2 remap."""
    (_, G, depth, nw), kw = CONFIGS[name]
    if depth == 2:
        depth, nw = 4, 8
    return G, depth, nw, kw.get("subm", 128), kw["lazy"], kw.get(
        "ext_passes", 0)


def _jax_stages(name):
    """One jitted, vmapped JAX function returning every stage's output."""
    G, depth, nw, subm, lazy, ext = _resolved(name)
    mcap = min(88, subm * G) if ext else 4 + 4 * nw

    def per_block(data, n):
        mlen, moff, valid = jdev._find_matches(data, n, B, depth=depth,
                                               nw=nw, ext_passes=ext)
        v = valid
        for _ in range(lazy):  # _encode_block_v2's lazy demotion
            nx_len = jnp.concatenate([mlen[1:], jnp.zeros(1, jnp.int32)])
            nx_val = jnp.concatenate([v[1:], jnp.zeros(1, bool)])
            v = v & ~(nx_val & (nx_len > mlen + 1))
        sel, cpos, cml, coff = jdev._grid_select(mlen, moff, v, B, G,
                                                 subm=subm, match_cap=mcap)
        out, body, tail, flag = jdev._emit_sorted(data, n, sel, cpos, cml,
                                                  coff, B, G)
        return (mlen, moff, valid, v, sel, cpos, cml, coff, out, body, tail,
                flag)

    return jax.jit(jax.vmap(per_block))


@pytest.fixture(scope="module")
def staged():
    arr, lens = _batch(BLOCKS)
    out = {}
    for name in CONFIGS:
        res = _jax_stages(name)(jnp.asarray(arr), jnp.asarray(lens))
        out[name] = [np.asarray(x) for x in res]
    return arr, lens, out


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), ref)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_find_matches(staged, name):
    arr, lens, ref = staged
    G, depth, nw, subm, lazy, ext = _resolved(name)
    mlen, moff, valid = tdev._find_matches(_t(arr), _t(lens), B, depth=depth,
                                           nw=nw, ext_passes=ext)
    for port, r in zip((mlen, moff, valid), ref[name][:3]):
        _eq(port, r)
    v = valid
    for _ in range(lazy):
        v = tdev._lazy_demote(mlen, v)
    _eq(v, ref[name][3])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_grid_select(staged, name):
    _, _, ref = staged
    G, depth, nw, subm, lazy, ext = _resolved(name)
    mlen, moff, _, v = ref[name][:4]
    got = tdev._grid_select(_t(mlen), _t(moff), _t(v), B, G, subm=subm,
                            match_cap=tdev._match_cap(G, nw, subm, ext))
    for port, r in zip(got, ref[name][4:8]):
        _eq(port, r)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_emit_sorted(staged, name):
    arr, lens, ref = staged
    G = _resolved(name)[0]
    sel, cpos, cml, coff, out, body, tail, flag = ref[name][4:]
    o, b, t, f = tdev._emit_sorted(_t(arr), _t(lens), _t(sel), _t(cpos),
                                   _t(cml), _t(coff), B, G)
    _eq(b, body)
    _eq(t, tail)
    _eq(f, flag)
    for i in range(len(BLOCKS)):
        np.testing.assert_array_equal(o[i, :body[i]].numpy(),
                                      out[i, :body[i]])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_make_encoder_batched(name):
    args, kw = CONFIGS[name]
    arr, lens = _batch(BLOCKS)
    jo, js, jt, jf = (np.asarray(x) for x in jdev.make_encoder(*args, **kw)(
        jnp.asarray(arr), jnp.asarray(lens)))
    to, ts, tt, tf = tdev.make_encoder(*args, **kw)(_t(arr), _t(lens))
    _eq(ts, js)
    _eq(tt, jt)
    _eq(tf, jf)
    assert to.shape == (len(BLOCKS), B) and to.dtype == torch.uint8
    for i in np.nonzero(~jf)[0]:
        np.testing.assert_array_equal(to[i, :js[i]].numpy(), jo[i, :js[i]])


def _flagged_block(seed: int) -> bytes:
    """A >=270-byte literal run closed by an exact 4-byte match: the
    sequence header needs more bytes than the match has spares."""
    rng = np.random.default_rng(seed)
    blk = bytearray(rng.integers(0, 256, B, dtype=np.uint8).tobytes())
    blk[300:304] = blk[8:12]
    blk[304] = blk[12] ^ 0x5A  # stop the match at exactly 4 bytes
    return bytes(blk)


def test_flagged_block_streams_match():
    enc = jdev.make_encoder(*CONFIGS["api_default"][0],
                            **CONFIGS["api_default"][1])
    for seed in range(16):
        blocks = [_flagged_block(seed), _payload("text", B, 1),
                  _payload("mixed", 700, 2)]
        arr, lens = _batch(blocks)
        flags = np.asarray(enc(jnp.asarray(arr), jnp.asarray(lens))[3])
        if flags.any():
            break
    assert flags.any()
    tflags = tdev.make_encoder(*CONFIGS["api_default"][0],
                               **CONFIGS["api_default"][1])(
        _t(arr), _t(lens))[3]
    _eq(tflags, flags)
    # the device batch reports the flagged block and leaves its body out
    tb, tt, flagged = tdev.encode_blocks(blocks, 2, device="cpu")
    assert flagged == np.nonzero(flags)[0].tolist()
    assert all((b is None) == (i in flagged) for i, b in enumerate(tb))
    # after the codec tier's host re-encode of it, the streams agree
    jb, jt = jdev.encode_blocks(blocks, 2)
    tb, tt = tlz4._device_bodies(blocks, 2, "cpu")
    assert tb == jb and tt == jt
    chunks, dlens = lz4_stitch.stitch_bodies(tb, tt, blocks)
    total = b"".join(blocks)
    assert sum(dlens) == len(total)
    assert native.lz4_decompress(b"".join(chunks), len(total)) == total


def test_exact_parse_not_ported():
    """The exact parse (G < 2) is ported now: its rows are out_capacity(B)
    wide, the sort-emit path's B wide, as in the JAX package
    (tests/test_torch_lz4_exact.py holds its parity)."""
    assert tdev.encoder_block_fn(B, 0)[1] == jdev.encoder_block_fn(B, 0)[1]
    assert tdev.encoder_block_fn(B, 0)[1] == tdev.out_capacity(B)
    _, width = tdev.encoder_block_fn(B, 4)
    assert width == B


def test_block_size_limit():
    with pytest.raises(ValueError):
        tdev.check_block_sizes([b"x" * (tdev.MAX_DEVICE_BLOCK + 1)])
    assert tdev._bucket(300) == 512 and tdev._bucket(1) == 256
    assert tdev.grid_for_accel(2) == 4 and tdev.grid_for_accel(9) == 32
    assert tdev.out_capacity(B) == jdev.out_capacity(B)
