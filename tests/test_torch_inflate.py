"""The port's device inflate (aocl_compression_tpu_torch/ops/
inflate_device.py): its stages against the JAX package's, and exact
decodes of stock-zlib, host-C++ and device-encoded chunks.

The stages run on one planned batch at a small output domain (B = 4096) so
each JAX function compiles once: the bit reader (_read_fwd) over its
edges, the canonical-code step (_huff_step) on real and empty alphabets,
the symbol scan's (kind, val, dist) slots whole, the compaction (the
literal buffer up to litregen, where the JAX package's unstable sort
leaves the rest unspecified, and every other output whole), the planner
and make_decoder's output and dlen. The batch holds mutated chunks too, so
the bad-code paths (no length holds a code, a match without distance
codes, distance symbols >= 30) are held to the JAX package's. Tolerance:
exact equality.

decode_chunks must return the input exactly; chunks the planner rejects
(stored-first, garbage), multi-block chunks and corrupt short decodes go
through the host callable; mutated streams never crash.

The JAX package is imported inside fixtures, so the card-only tests (the
kernel against its plain version, decode on the card) also run where JAX
is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_inflate.py
"""

import functools
import random
import zlib

import numpy as np
import pytest
import torch

import aocl_compression_tpu_torch as act
from aocl_compression_tpu_torch.codecs import zlib_bzip2_lzma as tzlib
from aocl_compression_tpu_torch.ops import deflate_device as tdefl
from aocl_compression_tpu_torch.ops import inflate_device as D
from aocl_compression_tpu_torch.parallel import container
from aocl_compression_tpu_torch.runtime import native
from aocl_compression_tpu_torch.utils import dispatch

B = 4096


def _payload(kind: str, n: int, seed: int = 0) -> bytes:
    rng = random.Random(seed)
    if kind == "text":
        words = [b"decode ", b"stream ", b"the ", b"block ", b"huffman "]
        out = bytearray()
        while len(out) < n:
            out += rng.choice(words)
        return bytes(out[:n])
    if kind == "rle":
        return b"z" * n
    if kind == "periodic":
        return (b"abcxyz" * (n // 6 + 1))[:n]
    if kind == "random":
        return bytes(rng.randrange(256) for _ in range(n))
    if kind == "mixed":
        return (_payload("text", n // 2, seed)
                + _payload("random", n - n // 2, seed + 1))
    raise ValueError(kind)


KINDS = ["text", "rle", "periodic", "mixed"]


def _raw(data: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


def _mutate(chunk: bytes, rng: random.Random) -> bytes:
    m = bytearray(chunk)
    pos = rng.randrange(len(m))
    m[pos] ^= 1 << rng.randrange(8)
    return bytes(m)


BLOCKS = [_payload(k, 3000 + 211 * i, seed=i) for i, k in enumerate(KINDS)]


@functools.lru_cache(maxsize=None)
def _batch():
    """(chunks, dlens): stock zlib at levels 1, 6, 9 and 6, the host C++
    encoder's sync-flushed chunks, the port's static and dynamic device
    chunks (10 chunks of BLOCKS), then 16 one-bit mutations of the stock
    chunk of the mixed block."""
    chunks = [_raw(b, lvl) for b, lvl in zip(BLOCKS, (1, 6, 9, 6))]
    dlens = [len(b) for b in BLOCKS]
    host, _ = tzlib._zlib_compress_blocks_host(BLOCKS[:2], 6)
    chunks += host
    dlens += dlens[:2]
    for level in (1, 2):
        chunks += tzlib._device_chunks(BLOCKS[2:], level, "cpu")
        dlens += dlens[2:4]
    rng = random.Random(5)
    for _ in range(16):
        chunks.append(_mutate(chunks[3], rng))
        dlens.append(dlens[3])
    return chunks, dlens


@functools.lru_cache(maxsize=None)
def _planned():
    """The planned lanes of _batch as numpy arrays, (cbytes, bitoff,
    params, the chunk of each planned lane), and three lanes made from the
    first one's parameters for the scan's bad-code paths: no distance
    codes (all-zero parameters, so every match is bad), every distance
    symbol 30, and the length symbols 257-285 turned into 286 and 287
    (length 258, no extra bits)."""
    chunks, _ = _batch()
    ok, bitoffs, params = D.plan_chunks(chunks)
    idx = np.nonzero(ok)[0]
    C = D._bucket(max(len(chunks[i]) for i in idx))
    arr = np.zeros((len(idx) + 3, C), np.uint8)
    for k, i in enumerate(idx):
        arr[k, :len(chunks[i])] = np.frombuffer(chunks[i], np.uint8)
    arr[len(idx):] = arr[0]
    bo = np.r_[bitoffs[idx], [bitoffs[idx[0]]] * 3].astype(np.int32)
    params = [np.concatenate([p[idx]] + [p[idx[:1]]] * 3) for p in params]
    n = len(idx)
    for p in params[4:]:
        p[n] = 0
    params[7][n + 1] = 30
    permL = params[3][n + 2]
    long_ = (permL >= 257) & (permL <= 285)
    permL[long_] = 286 + (permL[long_] & 1)
    return arr, bo, tuple(params), idx


def _t(x):
    return torch.from_numpy(np.array(x))


class _Host:
    """The host callable: the shared library's raw inflate, counted."""

    def __init__(self):
        self.calls = []

    def __call__(self, chunk: bytes, dlen: int) -> bytes:
        self.calls.append(dlen)
        return native.inflate(chunk, dlen, raw=True)


def _decode(chunks, dlens, **kw):
    host = _Host()
    return D.decode_chunks(list(chunks), list(dlens), device="cpu",
                           host_one=host, **kw), host.calls


@pytest.fixture(scope="module")
def jinf():
    from aocl_compression_tpu.ops import inflate_device
    return inflate_device


@pytest.fixture(scope="module")
def jnp():
    import jax.numpy
    return jax.numpy


def test_read_fwd_and_bitrev(jinf, jnp):
    import jax
    rng = np.random.default_rng(1)
    L, W = 64, 6
    words = rng.integers(0, 1 << 32, (L, W), dtype=np.uint64)
    pos = np.r_[[0, 1, 31, 32, 33, 159, 160, 175, 191, 200],
                rng.integers(0, 8 * 4 * W, L - 10)].astype(np.int32)
    nbits = np.r_[[0, 15, 15, 1, 13, 15, 15, 15, 15, 5],
                  rng.integers(0, 16, L - 10)].astype(np.int32)
    ref = jax.jit(jinf._read_fwd)(jnp.asarray(words.astype(np.uint32)),
                                  jnp.asarray(pos), jnp.asarray(nbits))
    got = D._read_fwd(_t(words.astype(np.int64)), _t(pos).long(),
                      _t(nbits))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    v = rng.integers(0, 1 << 15, 1000).astype(np.int32)
    np.testing.assert_array_equal(
        D._bitrev15(_t(v).long()).numpy(),
        np.asarray(jax.jit(jinf._bitrev15)(jnp.asarray(v))))


def test_huff_step(jinf, jnp):
    """Real litlen and distance alphabets, and the all-zero parameters of
    a block without distance codes (every code is bad)."""
    import jax
    arr, bitoff, params, _ = _planned()
    rng = np.random.default_rng(2)
    N = len(bitoff)
    peek = rng.integers(0, 1 << 15, N).astype(np.int32)
    zero = [np.zeros_like(p) for p in params[4:]]
    for fc, lim, rkb, perm in (params[:4], params[4:], zero):
        ref = jax.jit(jinf._huff_step, static_argnums=6)(
            jnp.asarray(peek), jnp.asarray(fc), jnp.asarray(lim),
            jnp.asarray(rkb), jnp.asarray(perm.reshape(-1)),
            jnp.asarray(np.arange(N, dtype=np.int32) * perm.shape[1]),
            perm.shape[1])
        got = D._huff_step(_t(peek).long(), *map(_t, (fc, lim, rkb, perm)))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (np.asarray(ref[1]) == 0).all()


def _lens_params(lens_rows, nsym):
    """Stacked canonical parameters of code-length rows (numpy)."""
    ps = [D._canon_params(np.asarray(r, np.int64), nsym) for r in lens_rows]
    return [np.stack(col) for col in zip(*ps)]


def _param_sets(kind, nsym, rng):
    """(fc, lim, rkb, perm) numpy rows of one kind for an alphabet of nsym
    symbols."""
    if kind == "plan":
        _, _, params, _ = _planned()
        p = params[:4] if nsym == 288 else params[4:]
        _, first = np.unique(np.concatenate(p, axis=1), axis=0,
                             return_index=True)
        return [x[np.sort(first)] for x in p]
    if kind == "random":  # not canonical: a random range per length
        n = 6
        ls = np.arange(16)
        fc = rng.integers(-2, 1 << ls, (n, 16))
        lim = fc + rng.integers(-1, (1 << ls) // 2 + 2, (n, 16))
        lim[ls < rng.integers(1, 14, (n, 1))] = 0   # no short codes
        rkb = rng.integers(-40, nsym + 40, (n, 16))
        # ranks past int32: rkb + code - fc in 64 bits, then clipped
        fc[0, 5], lim[0, 5], rkb[0, 5] = -5, 40, (1 << 31) - 1
        rkb[1, 6] = -(1 << 31)
        perm = rng.integers(-20, nsym + 12, (n, nsym))
        return [a.astype(np.int32) for a in (fc, lim, rkb, perm)]
    rows = []
    for _ in range(6):
        lens = np.zeros(nsym, np.int64)
        k = rng.integers(2, nsym)
        idx = rng.choice(nsym, k, replace=False)
        if kind == "incomplete":  # Kraft sum < 1, lengths up to 15
            lens[idx] = rng.integers(3, 16, k)
        else:  # over-subscribed: Kraft sum > 1
            lens[idx] = rng.integers(1, 6, k)
        rows.append(lens)
    if kind == "degenerate":  # all lengths 0; one symbol of length 1
        rows = [np.zeros(nsym, np.int64), np.eye(1, nsym, 5)[0].astype(int)]
    return _lens_params(rows, nsym)


@pytest.mark.parametrize("kind", ["plan", "random", "incomplete",
                                  "oversubscribed", "degenerate"])
def test_root_tables_match_huff_step(kind):
    """The kernel's lookup scheme (a root table of the low R bits, the walk
    over lengths R+1..15 where the entry is long) gives _huff_step's answer
    on every one of the 32,768 15-bit peeks, at the kernel's widths for the
    litlen and distance alphabets. Exact equality of nbits, and of sym
    wherever the code is valid (nbits > 0: a bad code's sym is unused)."""
    rng = np.random.default_rng(11)
    peeks = torch.arange(1 << 15)
    for nsym, R in ((288, D.ROOT_BITS_L), (32, D.ROOT_BITS_D)):
        fc, lim, rkb, perm = map(_t, _param_sets(kind, nsym, rng))
        n = fc.shape[0]
        tables = D.root_tables(fc, lim, rkb, perm, R)
        sym, nbits = D.root_decode(peeks.expand(n, -1), fc, lim, rkb, perm,
                                   R, tables)
        rep = [x.repeat_interleave(1 << 15, 0) for x in (fc, lim, rkb, perm)]
        w_sym, w_nb = D._huff_step(peeks.repeat(n), *rep)
        assert torch.equal(nbits.reshape(-1), w_nb)
        ok = w_nb > 0
        assert torch.equal(sym.reshape(-1)[ok], w_sym[ok])
        if kind in ("random", "incomplete"):  # the long path ran
            assert bool((tables[1] == 0).any()) and bool((w_nb > R).any())


def test_plan_chunks_matches_jax(jinf):
    chunks, _ = _batch()
    extra = [_raw(_payload("random", 3000, 7), 6), b"\x07\xff\xff\xff",
             b"\x06", b""]
    for c in (chunks, extra):
        ok, bo, params = D.plan_chunks(c)
        jok, jbo, jparams = jinf.plan_chunks(c)
        np.testing.assert_array_equal(ok, jok)
        np.testing.assert_array_equal(bo, jbo)
        for p, q in zip(params, jparams):
            np.testing.assert_array_equal(p, q)
    assert not ok.any()  # stored-first and garbage: all rejected


@pytest.fixture(scope="module")
def scan_ref(jinf, jnp):
    """The JAX package's symbol scan and compaction of the planned batch."""
    import jax
    arr, bitoff, params, _ = _planned()
    MAXS, MAXSEQ = B + 4, B // 3 + 2
    words = jinf._bytes_to_words(jnp.asarray(arr))
    slots = jax.jit(jinf._symbol_scan, static_argnums=10)(
        words, jnp.asarray(bitoff), *map(jnp.asarray, params), MAXS)
    comp = jax.jit(jax.vmap(lambda k, v, d: jinf._compact(k, v, d, B,
                                                          MAXSEQ)))(*slots)
    return [np.asarray(s) for s in slots], [np.asarray(c) for c in comp]


def test_symbol_scan_matches_jax(scan_ref):
    arr, bitoff, params, _ = _planned()
    got = D._symbol_scan_plain(D._bytes_to_words(_t(arr)), _t(bitoff),
                               *map(_t, params), B + 4)
    kind = scan_ref[0][0]
    # the batch reaches literals, matches, end-of-block and bad codes
    assert (kind == 1).any() and (kind == 2).any()
    for g, r in zip(got, scan_ref[0]):
        np.testing.assert_array_equal(g.numpy(), r)


def test_compact_matches_jax(scan_ref):
    got = D._compact_plain(*map(_t, scan_ref[0]), B, B // 3 + 2)
    litbuf, ll, ml, off, nbseq, litregen = (g.numpy() for g in got)
    rl, *rest = scan_ref[1]
    for k, n in enumerate(rest[4]):
        np.testing.assert_array_equal(litbuf[k, :n], rl[k, :n])
        assert not litbuf[k, n:].any()  # defined here: zeros
    for g, r in zip((ll, ml, off, nbseq, litregen), rest):
        np.testing.assert_array_equal(g, r)
    assert (nbseq > 0).any()


def test_make_decoder_matches_jax(jinf, jnp):
    arr, bitoff, params, idx = _planned()
    args = (arr, bitoff) + params
    jo, jd = jinf.make_decoder(B, arr.shape[1])(*map(jnp.asarray, args))
    stages = []
    o, d = D.make_decoder(B, arr.shape[1])(*map(_t, args),
                                           mark=stages.append)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert stages[0] == "symbol_scan" and stages[-1] == "gather_output"
    # the lanes of the 10 unmutated chunks decode to their blocks
    _, dlens = _batch()
    for k, i in enumerate(idx[:10]):
        assert i == k and d[k] == dlens[i]
        assert o[k, :d[k]].numpy().tobytes() == BLOCKS[(0, 1, 2, 3, 0, 1, 2,
                                                        3, 2, 3)[i]]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", [1, 6, 9])
def test_decodes_stock_streams(kind, level):
    data = _payload(kind, 2000, seed=level)
    assert _decode([_raw(data, level)], [len(data)]) == ([data], [])


def test_decodes_host_and_device_chunks():
    """The host C++ encoder's sync-flushed chunks (the zlib codec's RAP
    chunks) and the port's static (level 1) and dynamic (level 2) device
    chunks."""
    blocks = [_payload(k, 2500, seed=3) for k in KINDS]
    frags, dlens = tzlib._zlib_compress_blocks_host(blocks, 6)
    assert _decode(frags, dlens) == (blocks, [])
    for level in (1, 2):
        frags = tzlib._device_chunks(blocks, level, "cpu")
        assert _decode(frags, dlens) == (blocks, [])


def test_tiny_chunks():
    """dlens <= 256: the output domain B = 256 is below the compaction's
    512-byte row, so the rows are fetched whole."""
    blocks = [_payload("text", 200, 20), _payload("periodic", 256, 21),
              b"q"]
    assert _decode([_raw(b, 6) for b in blocks],
                   [len(b) for b in blocks]) == (blocks, [])


def test_sync_flush_trailer_ignored():
    data = _payload("text", 3000, seed=4)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = co.compress(data) + co.flush(zlib.Z_SYNC_FLUSH)
    assert _decode([raw], [len(data)]) == ([data], [])


def test_multiblock_falls_back_to_host():
    # two full-flush halves in one chunk: the device decodes only the
    # first block, its dlen mismatches, and the host decodes the chunk
    a = _payload("text", 1500, seed=5)
    b = _payload("mixed", 1500, seed=6)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = (co.compress(a) + co.flush(zlib.Z_FULL_FLUSH)
           + co.compress(b) + co.flush())
    single = _raw(a, 6)
    assert _decode([raw, single], [len(a) + len(b), len(a)]) == (
        [a + b, a], [len(a) + len(b)])


def test_stored_first_and_garbage_go_to_host():
    data = _payload("random", 2000, seed=7)
    raw = _raw(data, 6)  # incompressible: a stored block
    assert native.inflate_plan(raw) is None
    text = _payload("text", 2000, seed=8)
    assert _decode([raw, _raw(text, 6)], [len(data), len(text)]) == (
        [data, text], [len(data)])
    with pytest.raises(ValueError):
        _decode([b"\x07\xff\xff\xff\xff"], [100])


def test_mutated_streams_never_crash():
    """Corrupt chunks, decoded as one batch: the device output is garbage
    or short, the dlen gate sends short decodes to the host, and no chunk
    crashes the decoder; through the API, a stream with a mutated chunk
    decodes to the input or raises (the adler32 check)."""
    chunks, dlens = _batch()
    failed = []

    def host(chunk, dlen):
        try:
            return native.inflate(chunk, dlen, raw=True)
        except ValueError:
            failed.append(dlen)
            return b""

    out = D.decode_chunks(chunks[-16:], dlens[-16:], device="cpu",
                          host_one=host)
    assert sum(len(o) == dlens[3] for o in out) == 16 - len(failed)
    assert _decode([chunks[3]], [dlens[3]]) == ([BLOCKS[3]], [])

    h = act.setup("zlib", level=6, opt_var=2, block_size=2048, device="cpu")
    c = act.compress(h, BLOCKS[3])
    act.set_config(device_decode=True)
    try:
        rng = random.Random(9)
        for _ in range(4):
            m = bytearray(c)
            m[rng.randrange(len(c) - 200, len(c) - 8)] ^= 1 << rng.randrange(8)
            try:
                assert act.decompress(h, bytes(m)) == BLOCKS[3]
            except (ValueError, act.CompressionError):
                pass
    finally:
        act.set_config(device_decode=False)


def test_mem_limit_batches_same_output():
    chunks, dlens = _batch()
    sel = [0, 1, 4, 5]
    one = _decode([chunks[i] for i in sel], [dlens[i] for i in sel])
    assert one == ([BLOCKS[0], BLOCKS[1]] * 2, [])
    assert _decode([chunks[i] for i in sel], [dlens[i] for i in sel],
                   mem_limit=3500) == one


def test_large_block_gate():
    with pytest.raises(ValueError):
        _decode([b"x"], [1 << 20])


def test_unified_api_rap_device_decode(monkeypatch):
    """AOCL_DEVICE_DECODE=1 routes RAP decode of zlib streams to the TORCH
    tier: a device-encoded stream decodes exactly through the API; a host
    stream's stored chunks take the host route one by one; a host stream's
    128 KiB chunks go to the host tier whole."""
    monkeypatch.setenv("AOCL_DEVICE_DECODE", "1")
    monkeypatch.setenv("AOCL_ENABLE_INSTRUCTIONS", "XLA")
    data = (_payload("text", 4096, 12) + _payload("random", 2048, 13)
            + _payload("text", 2048, 14))
    dispatch.enable_audit(True)
    try:
        for level, stored in ((1, 0), (6, 1)):
            h = act.setup("zlib", level=level, opt_var=2, block_size=2048,
                          device="cpu")
            c = act.compress(h, data)
            assert zlib.decompress(container.skip_rap_frame(c)) == data
            dispatch.reset_audit()
            assert act.decompress(h, c, expected_size=len(data)) == data
            hits = dispatch.audit_hits()
            assert hits.get("zlib_decompress_blocks_torch") == 1, hits
            assert hits.get("zlib_inflate_chunk_host", 0) == stored, hits
        dispatch.reset_audit()
        big = _payload("text", 300000, seed=14)
        hb = act.setup("zlib", level=6, device="cpu")
        assert act.decompress(hb, act.compress(hb, big)) == big
        assert dispatch.audit_hits().get("zlib_decompress_blocks_host") == 1
    finally:
        dispatch.enable_audit(False)


# --- card-only: the kernel against its plain version ---------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain(cuda_device):
    from aocl_compression_tpu_torch.ops import inflate_scan
    arr, bitoff, params, _ = _planned()
    args = [_t(a) for a in (arr, bitoff) + params]
    want = D._scan_compact(*args, B, B // 3 + 2)
    n0 = inflate_scan.launches["inflate_symbol_scan"]
    got = D._scan_compact(*(a.to(cuda_device) for a in args), B, B // 3 + 2)
    torch.cuda.synchronize()
    assert inflate_scan.launches["inflate_symbol_scan"] == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


_STATIC_L = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
_STATIC_D = [5] * 32


def _adversarial(case, rng):
    """A corrupt or edge batch for the kernel: (cbytes, bitoff, params, B,
    MAXSEQ) numpy arrays and widths, N = 8 lanes of C = 2048 bytes."""
    N, C, B_ = 8, 2048, 1024
    maxseq = B_ // 3 + 2
    cb = rng.integers(0, 256, (N, C), dtype=np.uint8)
    bo = rng.integers(0, 64, N).astype(np.int32)
    static = _lens_params([_STATIC_L] * N, 288) + _lens_params(
        [_STATIC_D] * N, 32)
    params = static
    if case == "random_bytes":  # real parameters on random streams
        _, _, planned, _ = _planned()
        params = [np.concatenate([p[:N // 2], s[:N - N // 2]])
                  for p, s in zip(planned, static)]
    elif case in ("random_params", "incomplete", "oversubscribed"):
        kind = "random" if case == "random_params" else case
        params = [np.concatenate([p, p])[:N]
                  for p in _param_sets(kind, 288, rng)
                  + _param_sets(kind, 32, rng)]
    elif case == "bitoff_near_end":  # clamped reads of the last word
        bo = (8 * C - rng.integers(-300, 400, N)).astype(np.int32)
        cb[:, -16:] = rng.integers(0, 256, (N, 16), dtype=np.uint8)
    elif case == "step_cap":  # 1-bit literal codes: b + 4 steps
        lens = np.zeros(288, np.int64)
        lens[[65, 200]] = 1
        params = _lens_params([lens] * N, 288) + static[4:]
    elif case == "nseq_over_maxseq":  # 1-bit matches and distances
        lens = np.zeros(288, np.int64)
        lens[[65, 257, 270]] = [2, 1, 2]
        dl = np.zeros(32, np.int64)
        dl[[0, 29]] = 1
        params = _lens_params([lens] * N, 288) + _lens_params([dl] * N, 32)
        maxseq = 40
    return cb, bo, [np.ascontiguousarray(p, np.int32) for p in params], \
        B_, maxseq


_ADVERSARIAL = ["random_bytes", "random_params", "incomplete",
                "oversubscribed", "bitoff_near_end", "step_cap",
                "nseq_over_maxseq"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _ADVERSARIAL)
def test_kernel_matches_plain_adversarial(cuda_device, case):
    """The kernel against its plain version, output for output (exact), on
    corrupt and edge lanes: random streams, random or incomplete or
    over-subscribed parameters (codes up to 15 bits: the long path),
    positions at and past the row's end, the b + 4 step cap, and more
    matches than MAXSEQ."""
    rng = np.random.default_rng(_ADVERSARIAL.index(case))
    cb, bo, params, B_, maxseq = _adversarial(case, rng)
    args = [_t(a) for a in [cb, bo] + params]
    want = D._scan_compact(*args, B_, maxseq)
    got = D._scan_compact(*(a.to(cuda_device) for a in args), B_, maxseq)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if case == "step_cap":
        assert (want[5] == B_ + 4).all()
    if case == "nseq_over_maxseq":
        assert (want[4] > maxseq).all()


@pytest.mark.cuda
def test_decode_on_card(cuda_device):
    """64 KiB chunks: stock zlib's (its mixed block is several deflate
    blocks at zlib's 16K-symbol buffer, so it may take the host route) and
    the port's dynamic device chunks (one block each: all on the card)."""
    blocks = [_payload(k, 65536, s) for s, k in enumerate(KINDS)]
    for frags, hosted in (([_raw(b, 6) for b in blocks], 1),
                          (tzlib._device_chunks(blocks, 2, cuda_device), 0)):
        host = _Host()
        assert D.decode_chunks(frags, [len(b) for b in blocks],
                               device=cuda_device, host_one=host) == blocks
        assert len(host.calls) <= hosted
