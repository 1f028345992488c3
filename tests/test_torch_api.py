"""The port's unified API against the JAX package's: byte-identical RAP
streams for lz4 on the device tier (JAX at AOCL_ENABLE_INSTRUCTIONS=XLA,
the port on device="cpu") and on the host tier, round trips, the dispatch
audit, and device resolution."""

import random
import struct

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


def test_lz4_num_shards_requests_the_device_tier(device_tier):
    """num_shards > 1 requests the device tier at opt_var 0 (accel 1: the
    exact parse), as in the JAX package; under the XLA cap the TORCH tier
    serves it (tests/test_torch_multi.py holds the MULTI tier it reaches
    without a cap)."""
    data = _data("mixed")
    ref = actpu.compress(actpu.setup("lz4", num_shards=2, opt_var=0,
                                     block_size=4096), data)
    h = act.setup("lz4", num_shards=2, opt_var=0, block_size=4096,
                  device="cpu")
    tdispatch.enable_audit(True)
    try:
        c = act.compress(h, data)
        assert tdispatch.audit_hits().get("lz4_compress_blocks_torch") == 1
    finally:
        tdispatch.enable_audit(False)
    assert c == ref
    assert act.decompress(h, c) == data


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert act.setup("lz4").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            act.setup("lz4")


def test_unported_method_unsupported():
    # all seven methods are ported; a method outside the enum is
    # unsupported, as in the JAX package
    assert [c.name for c in act.list_codecs()] == [
        c.name for c in actpu.list_codecs()]
    with pytest.raises(act.CompressionError) as e:
        act.setup("brotli", device="cpu")
    assert e.value.code == act.ErrorCode.UNSUPPORTED_METHOD
    with pytest.raises(actpu.CompressionError) as je:
        actpu.setup("brotli")
    assert je.value.code == actpu.ErrorCode.UNSUPPORTED_METHOD
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


# --- snappy and zlib ----------------------------------------------------------

NEW_PATHS = {
    "snappy": ("snappy", dict(opt_var=2)),
    "zlib1": ("zlib", dict(level=1, opt_var=2)),
    "zlib2": ("zlib", dict(level=2, opt_var=2)),
}


def _serial_decode(method, c, n):
    """The stream after skip_rap_frame through a serial decoder: the host
    snappy decoder, stdlib zlib."""
    import zlib
    body = container.skip_rap_frame(c)
    if method == "snappy":
        return native.snappy_uncompress(body)
    return zlib.decompress(body)


@pytest.mark.parametrize("path", list(NEW_PATHS))
@pytest.mark.parametrize("kind", ["text", "mixed", "random"])
def test_new_device_tier_stream_identical(device_tier, kind, path):
    """setup("snappy", opt_var=2) and setup("zlib", level=1|2, opt_var=2):
    byte-identical RAP streams, audited on the device tier, read back by
    the API and by a serial decoder."""
    method, kw = NEW_PATHS[path]
    data = _data(kind)
    ref = actpu.compress(actpu.setup(method, block_size=B, **kw), data)
    h = act.setup(method, block_size=B, device="cpu", **kw)
    tdispatch.enable_audit(True)
    try:
        c = act.compress(h, data)
        hits = tdispatch.audit_hits()
    finally:
        tdispatch.enable_audit(False)
    assert hits.get(f"{method}_compress_blocks_torch") == 1
    assert hits.get("fetch_chunks_torch") == 1
    assert c == ref
    assert act.decompress(h, c) == data
    assert _serial_decode(method, c, len(data)) == data


@pytest.mark.parametrize("method,kw", [
    ("snappy", {}), ("zlib", dict(level=1)), ("zlib", dict(level=2)),
    ("zlib", dict(level=6))], ids=["snappy", "zlib1", "zlib2", "zlib6"])
def test_new_host_tier_stream_identical(method, kw):
    data = _data("mixed")
    ref = actpu.compress(actpu.setup(method, block_size=B, **kw), data)
    h = act.setup(method, block_size=B, device="cpu", **kw)
    c = act.compress(h, data)
    assert c == ref
    assert act.decompress(h, c) == data


def test_zlib_without_opt_in_stays_on_host(monkeypatch):
    """With no opt-in, calibrated dispatch keeps zlib levels 1-2 on the
    host tier (the port's table is empty, so no device tier is picked on
    its own); opt_var=2 or AOCL_ENABLE_INSTRUCTIONS naming a device tier
    selects the device tier (with no cap its top one, MULTI, where the JAX
    package picks MESH); the block size follows, as in the JAX package."""
    from aocl_compression_tpu_torch.utils import calibration
    monkeypatch.delenv("AOCL_ENABLE_INSTRUCTIONS", raising=False)
    assert calibration.MEASURED_MBPS == {}
    data = _data("text") * 40
    codec = act.get_codec("zlib")
    for kw, name in ((dict(level=1), "zlib_compress_blocks_host"),
                     (dict(level=2, opt_var=2), "zlib_compress_blocks_multi")):
        h = act.setup("zlib", device="cpu", **kw)
        tdispatch.enable_audit(True)
        try:
            c = act.compress(h, data)
            hits = tdispatch.audit_hits()
        finally:
            tdispatch.enable_audit(False)
        assert name in hits, hits
        assert act.decompress(h, c) == data
    assert codec._block_size(act.setup("zlib", level=1, device="cpu")) == \
        4 * 32768
    assert codec._block_size(act.setup("zlib", level=1, opt_var=2,
                                       device="cpu")) == 65536
    monkeypatch.setenv("AOCL_ENABLE_INSTRUCTIONS", "TORCH")
    assert codec._block_size(act.setup("zlib", level=2, device="cpu")) == \
        65536
    assert tdispatch.resolve("zlib", "compress_blocks", calibrated=True) \
        is not tdispatch.resolve_host("zlib", "compress_blocks")


def test_calibrated_dispatch_policy(monkeypatch):
    """best_tier: an empty entry keeps the host tier; a measured device
    tier wins only when faster."""
    from aocl_compression_tpu_torch.utils import calibration
    monkeypatch.delenv("AOCL_ENABLE_INSTRUCTIONS", raising=False)
    assert calibration.best_tier("zlib", "compress_blocks", [0, 1]) == 0
    assert calibration.best_tier("zlib", "compress_blocks", [1]) is None
    monkeypatch.setitem(calibration.MEASURED_MBPS,
                        ("zlib", "compress_blocks"), {0: 100.0, 1: 300.0})
    assert calibration.best_tier("zlib", "compress_blocks", [0, 1]) == 1
    assert tdispatch.resolve_with_tier("zlib", "compress_blocks",
                                       calibrated=True)[1] == 1
    monkeypatch.setitem(calibration.MEASURED_MBPS,
                        ("zlib", "compress_blocks"), {0: 100.0})
    assert tdispatch.resolve_with_tier("zlib", "compress_blocks",
                                       calibrated=True)[1] == 0
    # uncalibrated, the highest registered tier: MULTI, as the JAX
    # package's MESH
    assert tdispatch.resolve_with_tier("zlib", "compress_blocks")[1] == 3


def test_registered_tiers_match_jax():
    """With every codec module of both packages imported, the port's
    registry holds the JAX package's tiers for each (codec, op) the JAX
    package registers; the port's own pairs (routes the JAX package takes
    inside its codecs) list their registry keys."""
    import importlib
    import pkgutil

    import aocl_compression_tpu.codecs as jcodecs
    import aocl_compression_tpu_torch.codecs as tcodecs
    for pkg in (jcodecs, tcodecs):
        for m in pkgutil.iter_modules(pkg.__path__):
            importlib.import_module(f"{pkg.__name__}.{m.name}")
    for key in jdispatch._registry:
        assert tdispatch.registered_tiers(*key) == \
            jdispatch.registered_tiers(*key), key
    for key, impls in tdispatch._registry.items():
        assert tdispatch.registered_tiers(*key) == sorted(impls)
    assert tdispatch.registered_tiers("lz4", "compress_blocks") == [0, 1, 3]
    assert tdispatch.registered_tiers("nocodec", "compress") == []


def test_tier_labels_match_jax():
    """TIER_LABELS names the four tiers, as the JAX package's does; the
    JAX package's names map onto the same numbers."""
    from aocl_compression_tpu.utils import config as jconfig
    from aocl_compression_tpu_torch.utils import config as tconfig
    assert tconfig.TIER_LABELS == {0: "HOST", 1: "TORCH", 2: "KERNEL",
                                   3: "MULTI"}
    assert sorted(tconfig.TIER_LABELS) == sorted(jconfig.TIER_LABELS)
    for tier, name in jconfig.TIER_LABELS.items():
        assert tconfig._TIER_NAMES[name] == tier
        assert tconfig._TIER_NAMES[tconfig.TIER_LABELS[tier]] == tier


def test_snappy_device_decode_round_trip(device_tier, monkeypatch):
    """AOCL_DEVICE_DECODE=1 routes snappy RAP decode to the port's device
    decoder and zlib RAP decode to the device inflate (audited)."""
    data = _data("mixed")
    for method, kw in (NEW_PATHS["snappy"], NEW_PATHS["zlib2"]):
        h = act.setup(method, block_size=B, device="cpu", **kw)
        c = act.compress(h, data)
        tdispatch.enable_audit(True)
        try:
            monkeypatch.setenv("AOCL_DEVICE_DECODE", "1")
            assert act.decompress(h, c) == data
            hits = tdispatch.audit_hits()
        finally:
            tdispatch.enable_audit(False)
            monkeypatch.delenv("AOCL_DEVICE_DECODE")
        want = ("snappy_decompress_blocks_torch" if method == "snappy"
                else "zlib_decompress_blocks_torch")
        assert hits.get(want) == 1, hits


def test_new_format_routes_audited(device_tier):
    """The device tiers' routes to the host are audited by name: blocks
    over 64 KiB (snappy, zlib), a snappy block the sort-emit flags, a
    snappy decode batch with a chunk over 64 KiB, zlib single-shot input
    under 1 KiB; and the dynamic path's static re-encode."""
    from aocl_compression_tpu_torch.codecs import snappy as tsnappy
    from aocl_compression_tpu_torch.codecs import zlib_bzip2_lzma as tzlib
    from test_torch_snappy import _flagged_block
    big = _data("text") * 15
    cases = [
        (lambda: tsnappy._compress_blocks_torch([big, b"x" * 100], 2, "cpu"),
         "snappy_compress_blocks_host"),
        (lambda: tzlib._zlib_compress_blocks_torch([big, b"x" * 100], 1,
                                                   "cpu"),
         "zlib_compress_blocks_host"),
        (lambda: tsnappy._compress_blocks_torch(
            [_flagged_block(), _data("text")[:B]], 2, "cpu"),
         "snappy_compress_host"),
        (lambda: tsnappy._decompress_blocks_torch(
            [tsnappy._strip_preamble(native.snappy_compress(big))],
            [len(big)], B, "cpu"),
         "snappy_decompress_blocks_host"),
        (lambda: tzlib._zlib_compress_torch(b"tiny" * 100, 2, "cpu"),
         "zlib_compress_host"),
        (lambda: tzlib._device_chunks([b"", _data("text")[:B]], 2, "cpu"),
         "zlib_compress_static_torch"),
    ]
    for run, name in cases:
        tdispatch.enable_audit(True)
        try:
            run()
            hits = tdispatch.audit_hits()
        finally:
            tdispatch.enable_audit(False)
        assert hits.get(name) == 1, (name, hits)


@pytest.mark.parametrize("level", [1, 2])
def test_zlib_single_shot_device_stream_identical(device_tier, level):
    """The single-shot zlib stream of the device tier (no RAP frame)."""
    data = _data("text")[:3000]
    kw = dict(level=level, opt_var=2, enable_rap=False)
    ref = actpu.compress(actpu.setup("zlib", **kw), data)
    h = act.setup("zlib", device="cpu", **kw)
    c = act.compress(h, data)
    assert c == ref
    assert act.decompress(h, c) == data


def test_new_paths_mem_limit_keep_stream(device_tier):
    data = _data("mixed")
    for method, kw in NEW_PATHS.values():
        h = act.setup(method, block_size=B, device="cpu", **kw)
        hm = act.setup(method, block_size=B, device="cpu", mem_limit=2 * B,
                       **kw)
        assert act.compress(hm, data) == act.compress(h, data)


def test_new_paths_default_device_is_cuda():
    for method, kw in NEW_PATHS.values():
        if torch.cuda.is_available():
            assert act.setup(method, **kw).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError):
                act.setup(method, **kw)


# --- zstd ----------------------------------------------------------------------

def _audited(fn):
    tdispatch.enable_audit(True)
    try:
        out = fn()
        return out, tdispatch.audit_hits()
    finally:
        tdispatch.enable_audit(False)


@pytest.mark.parametrize("block_size", [4096, 8192])
@pytest.mark.parametrize("kind", ["text", "mixed"])
def test_zstd_device_tier_stream_identical(device_tier, monkeypatch, kind,
                                           block_size):
    """setup("zstd", level=1, opt_var=2): the RAP stream inside its
    skippable frame is byte-identical to the JAX package's, audited on the
    device tier, and decodes exactly through the host decoder and, with
    device decode on, through the port's device decoder."""
    kw = dict(level=1, opt_var=2, block_size=block_size)
    data = _data(kind) * 4
    ref = actpu.compress(actpu.setup("zstd", **kw), data)
    h = act.setup("zstd", device="cpu", **kw)
    c, hits = _audited(lambda: act.compress(h, data))
    assert hits.get("zstd_compress_blocks_torch") == 1
    assert hits.get("fetch_chunks_torch") == 2   # streams, sections
    assert c == ref
    assert struct.unpack_from("<I", c)[0] == 0x184D2A50
    assert native.zstd_decompress(c) == data     # skippable frame skipped
    d, hits = _audited(lambda: act.decompress(h, c))
    assert d == data and "zstd_decompress_blocks_host" in hits
    monkeypatch.setenv("AOCL_DEVICE_DECODE", "1")
    d, hits = _audited(lambda: act.decompress(h, c))
    assert d == data
    assert hits.get("zstd_decompress_blocks_torch") == 1, hits
    assert act.decompress(h, ref) == data


def test_zstd_single_shot_and_unknown_skippable(device_tier, monkeypatch):
    """Without RAP: the concatenated device frames (the JAX package's
    bytes); an unknown skippable frame in front is skipped on decode, by
    the host and by the device decoder."""
    data = _data("text")[:3000]
    kw = dict(level=1, opt_var=2, enable_rap=False)
    ref = actpu.compress(actpu.setup("zstd", **kw), data)
    h = act.setup("zstd", device="cpu", **kw)
    c, hits = _audited(lambda: act.compress(h, data))
    assert c == ref and hits.get("zstd_compress_torch") == 1
    skip = struct.pack("<II", 0x184D2A5E, 3) + b"abc"
    assert act.decompress(h, skip + c) == data
    monkeypatch.setenv("AOCL_DEVICE_DECODE", "1")
    d, hits = _audited(lambda: act.decompress(h, skip + c))
    assert d == data and hits.get("zstd_decompress_torch") == 1


@pytest.mark.parametrize("case", ["level3", "dictionary"])
def test_zstd_level3_and_dictionary_stay_on_host(device_tier, monkeypatch,
                                                 case):
    """Levels >= 2 and any dictionary keep the host tier, as in the JAX
    package: the same stream, audited as the host tier, also with device
    decode on."""
    data = _data("mixed") * 4
    kw = (dict(level=3, opt_var=2, block_size=4096) if case == "level3"
          else dict(level=1, opt_var=2, block_size=4096,
                    dictionary=_data("text")[:2000]))
    ref = actpu.compress(actpu.setup("zstd", **kw), data)
    h = act.setup("zstd", device="cpu", **kw)
    c, hits = _audited(lambda: act.compress(h, data))
    assert c == ref
    assert hits.get("zstd_compress_blocks_host") == 1
    assert not any(k.endswith("_torch") for k in hits), hits
    monkeypatch.setenv("AOCL_DEVICE_DECODE", "1")
    d, hits = _audited(lambda: act.decompress(h, c))
    assert d == data
    want = ("zstd_decompress_blocks_host" if case == "dictionary"
            else "zstd_decompress_blocks_torch")
    assert want in hits, hits


def test_zstd_host_tier_and_default_device():
    data = _data("mixed") * 4
    for kw in (dict(level=1, block_size=4096), dict(level=19)):
        ref = actpu.compress(actpu.setup("zstd", **kw), data)
        h = act.setup("zstd", device="cpu", **kw)
        c = act.compress(h, data)
        assert c == ref and act.decompress(h, c) == data
    if torch.cuda.is_available():
        assert act.setup("zstd", opt_var=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            act.setup("zstd", opt_var=2)
