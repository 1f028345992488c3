"""The port's unified API against the JAX package's: byte-identical RAP
streams for lz4 on the device tier (JAX at AOCL_ENABLE_INSTRUCTIONS=XLA,
the port on device="cpu") and on the host tier, round trips, the dispatch
audit, and device resolution."""

import random

import numpy as np
import pytest
import torch

import aocl_compression_tpu as actpu
import aocl_compression_tpu_torch as act
from aocl_compression_tpu.utils import dispatch as jdispatch
from aocl_compression_tpu_torch.parallel import container
from aocl_compression_tpu_torch.runtime import native
from aocl_compression_tpu_torch.utils import dispatch as tdispatch

B = 1024


def _data(kind: str) -> bytes:
    """4 full blocks + a short one (5 RAP chunks, one compactor shape)."""
    n = 4 * B + 333
    rng = random.Random(11)
    words = [b"hash ", b"match ", b"the ", b"block ", b"stream "]
    text = bytearray()
    while len(text) < n:
        text += rng.choice(words)
    rnd = np.random.default_rng(5).integers(0, 256, n, dtype=np.uint8)
    if kind == "text":
        return bytes(text[:n])
    if kind == "random":
        return rnd.tobytes()
    return bytes(text[:n // 2]) + rnd[:n - n // 2].tobytes()  # mixed


@pytest.fixture
def device_tier(monkeypatch):
    monkeypatch.setenv("AOCL_ENABLE_INSTRUCTIONS", "XLA")


@pytest.mark.parametrize("kind", ["text", "mixed", "random"])
def test_device_tier_stream_identical(device_tier, kind):
    data = _data(kind)
    ref = actpu.compress(actpu.setup("lz4", opt_var=2, block_size=B), data)
    h = act.setup("lz4", opt_var=2, block_size=B, device="cpu")
    c = act.compress(h, data)
    assert c == ref
    assert act.decompress(h, c) == data
    assert native.lz4_decompress(container.skip_rap_frame(c),
                                 len(data)) == data


def test_single_shot_device_stream_identical(device_tier):
    data = _data("text")[:1500]
    ref = actpu.compress(actpu.setup("lz4", opt_var=2), data)
    h = act.setup("lz4", opt_var=2, device="cpu")
    c = act.compress(h, data)
    assert c == ref
    assert act.decompress(h, c) == data


def test_mem_limit_keeps_stream(device_tier):
    data = _data("mixed")
    h = act.setup("lz4", opt_var=2, block_size=B, device="cpu")
    hm = act.setup("lz4", opt_var=2, block_size=B, device="cpu",
                   mem_limit=2 * B)
    assert act.compress(hm, data) == act.compress(h, data)


def test_lz4hc_mem_limit_keeps_stream(device_tier, monkeypatch):
    """mem_limit bounds the lz4hc device batches (here 2 blocks each) and
    leaves the stream as it is."""
    from aocl_compression_tpu_torch.ops import lz4_device
    data = _data("mixed")
    h = act.setup("lz4hc", opt_var=2, level=4, block_size=B, device="cpu")
    hm = act.setup("lz4hc", opt_var=2, level=4, block_size=B, device="cpu",
                   mem_limit=2 * B)
    ref = act.compress(h, data)
    batches = []
    encode = lz4_device.encode_blocks

    def counted(blocks, *args, **kwargs):
        batches.append(len(blocks))
        return encode(blocks, *args, **kwargs)

    monkeypatch.setattr(lz4_device, "encode_blocks", counted)
    assert act.compress(hm, data) == ref
    assert batches == [2, 2, 1]


def test_host_tier_stream_identical():
    data = _data("mixed")
    ref = actpu.compress(actpu.setup("lz4", block_size=B), data)
    h = act.setup("lz4", block_size=B, device="cpu", measure_stats=True)
    c = act.compress(h, data)
    assert c == ref
    assert act.decompress(h, c) == data
    assert h.stats.c_size == len(c) and h.stats.d_size == len(data)


def test_audit_shows_port_tiers_only(device_tier):
    data = _data("text")
    h = act.setup("lz4", opt_var=2, block_size=B, device="cpu")
    tdispatch.enable_audit(True)
    jdispatch.enable_audit(True)
    try:
        act.compress(h, data)
        hits = tdispatch.audit_hits()
        assert hits.get("lz4_compress_blocks_torch") == 1
        assert hits.get("fetch_chunks_torch") == 1
        assert tdispatch.validate_tier_access(1)
        assert jdispatch.audit_hits() == {}
    finally:
        tdispatch.enable_audit(False)
        jdispatch.enable_audit(False)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert act.setup("lz4").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            act.setup("lz4")


def test_unported_method_unsupported():
    with pytest.raises(act.CompressionError) as e:
        act.setup("zstd", device="cpu")
    assert e.value.code == act.ErrorCode.UNSUPPORTED_METHOD
    assert act.version() != actpu.version()
    assert act.compress_bound("lz4", 1 << 20) == actpu.compress_bound(
        "lz4", 1 << 20)


@pytest.mark.parametrize("level", [4, 9])
@pytest.mark.parametrize("kind", ["text", "mixed", "random"])
def test_lz4hc_device_tier_stream_identical(device_tier, kind, level):
    """setup("lz4hc", opt_var=2): the exact-parse device encoder (G = 0) at
    the level's depth / nw / lazy, byte-identical RAP streams."""
    data = _data(kind)
    ref = actpu.compress(actpu.setup("lz4hc", level=level, opt_var=2,
                                     block_size=B), data)
    h = act.setup("lz4hc", level=level, opt_var=2, block_size=B,
                  device="cpu")
    tdispatch.enable_audit(True)
    try:
        c = act.compress(h, data)
        assert tdispatch.audit_hits().get("lz4hc_compress_blocks_torch") == 1
    finally:
        tdispatch.enable_audit(False)
    assert c == ref
    assert act.decompress(h, c) == data
    assert native.lz4_decompress(container.skip_rap_frame(c),
                                 len(data)) == data


def test_lz4hc_host_tier_stream_identical():
    data = _data("mixed")
    ref = actpu.compress(actpu.setup("lz4hc", level=9, block_size=B), data)
    h = act.setup("lz4hc", level=9, block_size=B, device="cpu")
    c = act.compress(h, data)
    assert c == ref
    assert act.decompress(h, c) == data


@pytest.mark.parametrize("method", ["lz4", "lz4hc"])
def test_device_decode_round_trip(device_tier, monkeypatch, method):
    """AOCL_DEVICE_DECODE=1 routes RAP decode to the port's device decoder
    (audited), which returns the input; without it the host decoder runs."""
    data = _data("mixed")
    h = act.setup(method, opt_var=2, block_size=B, device="cpu")
    c = act.compress(h, data)
    tdispatch.enable_audit(True)
    try:
        monkeypatch.setenv("AOCL_DEVICE_DECODE", "1")
        assert act.decompress(h, c) == data
        hits = tdispatch.audit_hits()
        assert hits.get("lz4_decompress_blocks_torch") == 1
        assert "lz4_decompress_blocks_host" not in hits
        monkeypatch.setenv("AOCL_DEVICE_DECODE", "0")
        assert act.decompress(h, c) == data
        assert tdispatch.audit_hits().get("lz4_decompress_blocks_host") == 1
    finally:
        tdispatch.enable_audit(False)


def test_device_decode_config_switch(monkeypatch):
    """set_config(device_decode=True) turns device decode on; the env var
    overrides it either way, as in the JAX package."""
    from aocl_compression_tpu_torch.utils import config
    monkeypatch.delenv("AOCL_DEVICE_DECODE", raising=False)
    assert not config.device_decode_enabled()
    monkeypatch.setattr(config.get_config(), "device_decode", True)
    assert config.device_decode_enabled()
    monkeypatch.setenv("AOCL_DEVICE_DECODE", "0")
    assert not config.device_decode_enabled()


def test_device_decode_routes_big_chunks_to_host():
    """A chunk decoding to more than 64 KiB is past the decoder's 16-bit
    packing: it alone goes to the host tier (audited); the rest decode on
    the device."""
    from aocl_compression_tpu_torch.codecs import lz4 as tlz4
    big = _data("text") * 15
    small = _data("random")[:1000]
    assert len(big) > 65536
    chunks = [native.lz4_compress(big), native.lz4_compress(small)]
    tdispatch.enable_audit(True)
    try:
        out = tlz4._decompress_blocks_torch(chunks, [len(big), len(small)],
                                            B, "cpu")
        assert tdispatch.audit_hits().get("lz4_decompress_blocks_host") == 1
    finally:
        tdispatch.enable_audit(False)
    assert out == [big, small]


def test_lz4hc_default_device_is_cuda():
    """setup("lz4hc", opt_var=2) without a device means cuda: it raises
    where there is no card and never falls back to the CPU."""
    if torch.cuda.is_available():
        assert act.setup("lz4hc", opt_var=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            act.setup("lz4hc", opt_var=2)
