"""The port's host surface against the JAX package's, byte for byte on the
same seeded inputs: the new ctypes bindings, CompressStream /
DecompressStream, LZ4 frames (host tier, and the device tier with
device="cpu" against the JAX package at AOCL_ENABLE_INSTRUCTIONS=XLA),
.xz, zstd dictionary training and the native API.

A wrong ctypes signature corrupts data without failing, so every binding
is held to the JAX binding's result on the same bytes."""

import bz2
import gzip
import lzma
import zlib

import numpy as np
import pytest
import torch

import aocl_compression_tpu as actpu
import aocl_compression_tpu_torch as act
from aocl_compression_tpu import native_api as japi
from aocl_compression_tpu import streaming as jstreaming
from aocl_compression_tpu.codecs import lz4_frame as jframe
from aocl_compression_tpu.codecs import xz as jxz
from aocl_compression_tpu.codecs import zstd as jzstd
from aocl_compression_tpu.runtime import native as jnative
from aocl_compression_tpu.utils import dispatch as jdispatch
from aocl_compression_tpu.utils.config import TIER_XLA
from aocl_compression_tpu_torch import native_api as tapi
from aocl_compression_tpu_torch import streaming as tstreaming
from aocl_compression_tpu_torch.codecs import lz4_frame as tframe
from aocl_compression_tpu_torch.codecs import xz as txz
from aocl_compression_tpu_torch.codecs import zstd as tzstd
from aocl_compression_tpu_torch.runtime import native as tnative
from aocl_compression_tpu_torch.utils import dispatch as tdispatch
from aocl_compression_tpu_torch.utils.config import TIER_TORCH


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"stream ", b"of ", b"hash ", b"match ", b"block ",
             b"compressed ", b"frame ", b"window "]
    idx = rng.integers(0, len(words), n // 3 + 8)
    return b"".join(words[i] for i in idx)[:n]


def _mixed(n: int, seed: int) -> bytes:
    """Text with a random stretch in the middle (stored LZ4 blocks,
    uncompressed LZMA2 chunks)."""
    rnd = np.random.default_rng(seed).integers(0, 256, n // 4,
                                               dtype=np.uint8).tobytes()
    return (_text(n // 2, seed) + rnd + _text(n, seed + 1))[:n]


DATA = _mixed(150_000, 1)
# two 64 KiB frame blocks and a tail under 1,024 bytes (the host route of
# the lz4 device tier's single-shot encoder)
FRAME_DATA = _text(2 * 65536 + 700, 3)


# --- bindings ----------------------------------------------------------------

def _pieces(data, seed=0):
    rng = np.random.default_rng(seed)
    out, pos = [], 0
    while pos < len(data):
        k = int(rng.integers(1, 5000))
        out.append(data[pos:pos + k])
        pos += k
    return out


def _zstd_frames(n):
    return (n.zstd_compress(DATA[:40000], 3)
            + n.zstd_compress(DATA[40000:90000], 1))


def _stats(n):
    with n.ZstdStatsCapture() as st:
        for i in range(0, 60000, 6000):
            n.zstd_compress(DATA[i:i + 6000], 3, DATA[100000:110000])
    return [list(st.lit), list(st.ll), list(st.of), list(st.ml)]


def _xxh_stream(n):
    st = n.XXH32Stream(5)
    for p in _pieces(DATA):
        st.update(p)
    return st.digest()


def _stream_decode(cls, stream):
    dec = cls()
    return b"".join(dec.decode(p) for p in _pieces(stream, 1)) + \
        dec.decode(b"", final=True)


BINDINGS = {
    "xxh32": lambda n: [n.xxh32(DATA[:k], s)
                        for k in (0, 1, 15, 16, 17, 4096, len(DATA))
                        for s in (0, 1, 0x9E3779B1)],
    "xxh64": lambda n: [n.xxh64(DATA[:k], s)
                        for k in (0, 1, 31, 32, 33, len(DATA))
                        for s in (0, 1 << 40)],
    "XXH32Stream": _xxh_stream,
    "crc32": lambda n: [n.crc32(DATA[:k], s) for k in (0, 1, 1000, len(DATA))
                        for s in (0, 0xDEADBEEF)],
    "adler32": lambda n: [n.adler32(DATA[:k], s)
                          for k in (0, 1, 5552, len(DATA)) for s in (1, 77)],
    "lz4_compress_continue": lambda n: [
        n.lz4_compress_continue(DATA[65536:131072], DATA[:65536], a)
        for a in (1, 4)] + [n.lz4_compress_continue(DATA[:3000], b"")],
    "lz4_decompress_with_history": lambda n: n.lz4_decompress_with_history(
        jnative.lz4_compress_continue(DATA[65536:131072], DATA[:65536]),
        65536, DATA[:65536]),
    "zstd_decompress_frame": lambda n: [
        n.zstd_decompress_frame(_zstd_frames(jnative)),
        n.zstd_decompress_frame(_zstd_frames(jnative)[:50]),
        n.zstd_decompress_frame(b"\x28\xb5")],
    "inflate_consumed": lambda n: n.inflate_consumed(
        jnative.deflate(DATA, 6, jnative.DEFLATE_RAW) + b"trailer"),
    "gzip_compress": lambda n: [n.gzip_compress(DATA, lv) for lv in (1, 6)],
    "gzip_decompress": lambda n: n.gzip_decompress(
        gzip.compress(DATA[:70000]) + gzip.compress(DATA[70000:], 9)),
    "InflateStream": lambda n: _stream_decode(
        n.InflateStream, zlib.compress(DATA, 6)),
    "Bz2DecodeStream": lambda n: _stream_decode(
        n.Bz2DecodeStream, bz2.compress(DATA[:60000]) + bz2.compress(
            DATA[60000:])),
    "zstd_build_dict_header": lambda n: [
        n.zstd_build_dict_header(*a)
        for a in ((_stats(jnative)[0], 0x80001234),
                  (_stats(jnative)[0], 0xFFFFFFFF, *_stats(jnative)[1:]))],
    "ZstdStatsCapture": _stats,
}


@pytest.mark.parametrize("name", list(BINDINGS))
def test_binding_matches_jax(name):
    got = BINDINGS[name](tnative)
    assert got == BINDINGS[name](jnative)
    if name in ("InflateStream", "Bz2DecodeStream", "gzip_decompress"):
        assert got == DATA
    if name == "lz4_decompress_with_history":
        assert got == DATA[65536:131072]
    if name == "zstd_decompress_frame":
        assert got[0] == (DATA[:40000], len(jnative.zstd_compress(
            DATA[:40000], 3)))
        assert got[1:] == [None, None]
    if name == "inflate_consumed":
        assert got[0] == DATA


# --- streams -----------------------------------------------------------------

STREAM_CODECS = ["zlib", "gzip", "zstd", "bzip2", "lz4"]
STOCK = {"zlib": zlib.decompress, "gzip": gzip.decompress,
         "bzip2": bz2.decompress}


def _write_all(cs, data, seed=2):
    return b"".join(cs.write(p) for p in _pieces(data, seed)) + cs.finish()


def _stream(mod, codec):
    return _write_all(mod.CompressStream(codec, block_size=1 << 15), DATA)


@pytest.mark.parametrize("codec", STREAM_CODECS)
def test_compress_stream_matches_jax(codec):
    got = _stream(tstreaming, codec)
    assert got == _stream(jstreaming, codec)
    if codec in STOCK:
        assert STOCK[codec](got) == DATA


@pytest.mark.parametrize("codec", STREAM_CODECS)
def test_decompress_stream_cross(codec):
    """The port's DecompressStream reads the JAX package's stream, fed in
    small pieces, and the JAX package's reads the port's."""
    for enc, dec in ((jstreaming, tstreaming), (tstreaming, jstreaming)):
        stream = _stream(enc, codec)
        ds = dec.DecompressStream(codec)
        out = b"".join(ds.write(p) for p in _pieces(stream, 3)) + ds.finish()
        assert out == DATA


def test_stream_exported_at_top_level():
    assert act.CompressStream is tstreaming.CompressStream
    assert act.DecompressStream is tstreaming.DecompressStream
    with pytest.raises(ValueError):
        act.CompressStream("snappy")


# --- LZ4 frames --------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    {}, dict(block_checksum=True), dict(block_size_id=5, accel=3),
    dict(content_checksum=False, store_content_size=False)])
def test_frame_host_tier_matches_jax(opts):
    got = tframe.compress_frame(DATA, **opts)
    assert got == jframe.compress_frame(DATA, **opts)
    assert tframe.decompress_frame(got) == DATA


@pytest.mark.parametrize("kw", [{}, dict(max_tier=TIER_TORCH),
                                dict(max_tier=0, opt_off=True),
                                dict(opt_off=False)])
def test_decompress_frame_takes_jax_arguments(kw):
    """decompress_frame takes the JAX package's max_tier and opt_off and
    decodes on the host whatever they are, as the JAX function does."""
    frame = jframe.compress_frame(DATA, block_checksum=True)
    assert tframe.decompress_frame(frame, **kw) == \
        jframe.decompress_frame(frame, **kw) == DATA


def test_frame_decodes_linked_blocks():
    """A linked-block frame (CompressStream("lz4")) decodes through the
    port's decompress_frame, carrying the 64 KiB history."""
    stream = _stream(jstreaming, "lz4")
    assert tframe.decompress_frame(stream) == DATA
    bad = bytearray(stream)
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError):
        tframe.decompress_frame(bytes(bad))


@pytest.fixture
def device_blocks(monkeypatch):
    """The device tier at 4 KiB blocks in both packages (one small JAX
    compile), the previous block size restored after."""
    monkeypatch.setenv("AOCL_ENABLE_INSTRUCTIONS", "XLA")
    saved = act.get_config().default_block_size, \
        actpu.get_config().default_block_size
    act.set_config(default_block_size=4096)
    actpu.set_config(default_block_size=4096)
    yield
    act.set_config(default_block_size=saved[0])
    actpu.set_config(default_block_size=saved[1])


def test_frame_device_tier_matches_jax(device_blocks):
    tdispatch.enable_audit(True)
    try:
        got = tframe.compress_frame(FRAME_DATA, accel=2, block_checksum=True,
                                    max_tier=TIER_TORCH, device="cpu")
        hits = tdispatch.audit_hits()
    finally:
        tdispatch.enable_audit(False)
    jdispatch.enable_audit(True)
    try:
        ref = jframe.compress_frame(FRAME_DATA, accel=2, block_checksum=True,
                                    max_tier=TIER_XLA)
        assert jdispatch.audit_hits().get("lz4_compress_xla") == 1
    finally:
        jdispatch.enable_audit(False)
    assert got == ref
    # one resolve per frame; the 700-byte tail takes the host route
    assert hits["lz4_compress_torch"] == 1
    assert hits["lz4_compress_host"] == 1
    assert tframe.decompress_frame(got) == FRAME_DATA


def test_native_api_lz4_compress_fast_device_tier(device_blocks):
    got = tapi.LZ4_compress_fast(FRAME_DATA[:65536], 2, device="cpu")
    assert got == japi.LZ4_compress_fast(FRAME_DATA[:65536], 2)
    assert got == act.compress(act.setup("lz4", opt_var=2, enable_rap=False,
                                         device="cpu"), FRAME_DATA[:65536])
    assert tapi.LZ4_decompress_safe(got, 65536, device="cpu") == \
        FRAME_DATA[:65536]


def test_cuda_requested_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    # a host-tier frame needs no device
    monkeypatch.setenv("AOCL_ENABLE_INSTRUCTIONS", "HOST")
    assert tframe.compress_frame(FRAME_DATA, max_tier=TIER_TORCH) == \
        jframe.compress_frame(FRAME_DATA)
    monkeypatch.setenv("AOCL_ENABLE_INSTRUCTIONS", "XLA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tframe.compress_frame(FRAME_DATA, max_tier=TIER_TORCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.LZ4_compress_default(FRAME_DATA)


# --- .xz ---------------------------------------------------------------------

@pytest.mark.parametrize("level,block_size", [(6, 0), (1, 1 << 15)])
def test_xz_matches_jax(level, block_size):
    got = txz.xz_compress(DATA, level, block_size=block_size)
    assert got == jxz.xz_compress(DATA, level, block_size=block_size)
    assert lzma.decompress(got) == DATA
    idx = txz.xz_index(got)
    assert idx == jxz.xz_index(got)
    pos = 0
    for off, _, usize in idx:
        assert txz.xz_decompress_block(got, off) == DATA[pos:pos + usize]
        pos += usize
    assert pos == len(DATA)
    stock = lzma.compress(DATA, format=lzma.FORMAT_XZ, preset=1)
    assert txz.xz_decompress(stock) == DATA
    assert txz.xz_index(stock) == jxz.xz_index(stock)


# --- dictionaries ------------------------------------------------------------

SAMPLES = [DATA[i:i + 1500] for i in range(0, 75000, 1500)]


@pytest.mark.parametrize("entropy", [True, False])
def test_train_dictionary_matches_jax(entropy):
    d = tzstd.train_dictionary(SAMPLES, 4096, entropy=entropy)
    assert d == jzstd.train_dictionary(SAMPLES, 4096, entropy=entropy)
    assert len(d) <= 4096
    # a dictionary from either package loads in the other's zstd codec
    data = DATA[80000:120000]
    th = act.setup("zstd", dictionary=d, block_size=16384, device="cpu")
    jh = actpu.setup("zstd", dictionary=d, block_size=16384)
    c = act.compress(th, data)
    assert c == actpu.compress(jh, data)
    assert actpu.decompress(jh, c) == data
    assert act.decompress(th, actpu.compress(jh, data)) == data


# --- the native API ----------------------------------------------------------

DICT = jzstd.train_dictionary(SAMPLES, 4096)


def _dev(m):
    return {"device": "cpu"} if m is tapi else {}


NATIVE = {
    "LZ4_compress_default": lambda m: m.LZ4_compress_default(DATA, **_dev(m)),
    "LZ4_compress_fast": lambda m: m.LZ4_compress_fast(DATA, 1, **_dev(m)),
    "LZ4_compress_HC": lambda m: m.LZ4_compress_HC(DATA, 4, **_dev(m)),
    "snappy_compress": lambda m: m.snappy_compress(DATA, **_dev(m)),
    "compress2": lambda m: m.compress2(DATA, 2, **_dev(m)),
    "BZ2_bzBuffToBuffCompress": lambda m: m.BZ2_bzBuffToBuffCompress(
        DATA, 1, **_dev(m)),
    "LzmaEncode": lambda m: m.LzmaEncode(DATA[:50000], 1, **_dev(m)),
    "ZSTD_compress": lambda m: m.ZSTD_compress(DATA, 5, **_dev(m)),
    "ZSTD_compress_usingDict": lambda m: m.ZSTD_compress_usingDict(
        DATA[:20000], DICT, 3, **_dev(m)),
    "LZ4F_compressFrame": lambda m: m.LZ4F_compressFrame(
        DATA, block_checksum=True),
    "lzma_easy_buffer_encode": lambda m: m.lzma_easy_buffer_encode(
        DATA[:50000], 1),
    "ZDICT_trainFromBuffer": lambda m: m.ZDICT_trainFromBuffer(SAMPLES, 2048),
    "bounds and helpers": lambda m: [
        m.LZ4_compressBound(1000), m.snappy_max_compressed_length(1000),
        m.compressBound(1000), m.ZSTD_compressBound(1000),
        m.snappy_uncompressed_length(jnative.snappy_compress(DATA)),
        m.ZSTD_getFrameContentSize(jnative.zstd_compress(DATA, 1)),
        m.XXH32(DATA, 3)],
}
DECODE = {
    "LZ4_compress_default": lambda c: tapi.LZ4_decompress_safe(
        c, len(DATA), device="cpu"),
    "LZ4_compress_fast": lambda c: tapi.LZ4_decompress_safe(
        c, len(DATA), device="cpu"),
    "LZ4_compress_HC": lambda c: tapi.LZ4_decompress_safe(
        c, len(DATA), device="cpu"),
    "snappy_compress": lambda c: tapi.snappy_uncompress(c, device="cpu"),
    "compress2": lambda c: tapi.uncompress(c, len(DATA), device="cpu"),
    "BZ2_bzBuffToBuffCompress": lambda c: tapi.BZ2_bzBuffToBuffDecompress(
        c, len(DATA), device="cpu"),
    "LzmaEncode": lambda c: tapi.LzmaDecode(c, 50000, device="cpu")
    + DATA[50000:],
    "ZSTD_compress": lambda c: tapi.ZSTD_decompress(c, len(DATA),
                                                    device="cpu"),
    "ZSTD_compress_usingDict": lambda c: tapi.ZSTD_decompress_usingDict(
        c, DICT, 20000, device="cpu") + DATA[20000:],
    "LZ4F_compressFrame": tapi.LZ4F_decompressFrame,
    "lzma_easy_buffer_encode": lambda c: tapi.lzma_stream_buffer_decode(c)
    + DATA[50000:],
}


@pytest.mark.parametrize("name", list(NATIVE))
def test_native_api_matches_jax(name):
    got = NATIVE[name](tapi)
    assert got == NATIVE[name](japi)
    if name in DECODE:
        assert DECODE[name](got) == DATA
