"""Parity of the port's zstd encoder (aocl_compression_tpu_torch/ops/
zstd_device.py) with the JAX package's.

The same numpy inputs go through each JAX function (jitted and vmapped on
the CPU) and its counterpart in the port on device="cpu"; the pipelines are
integer-only apart from _choose_seq_table's float32 costs, and the
tolerance is exact equality, flags included. Stages: _block_huffman,
_encode_weights, _normalize_counts, _fse_encode_tables (also against the
scalar FSE table builder), _choose_seq_table, the FSE scan's plain loop
(against a scalar walk of the same tables), make_encoder's whole output at
G = 4 (level 1) and G = 0 (level >= 3), and encode_blocks frame for frame
over six payload kinds, at 2-4 KiB blocks and one 64 KiB block.

The JAX package is imported inside fixtures, so the card-only tests (the
FSE scan kernel against its plain loop) also run where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_zstd.py
"""

import functools
import random

import numpy as np
import pytest
import torch

from aocl_compression_tpu_torch.codecs import zstd_format as ZF
from aocl_compression_tpu_torch.ops import zstd_device as tdev
from aocl_compression_tpu_torch.runtime import native

B = 4096
KINDS = ["text", "rle", "periodic", "random", "high", "mixed"]


def _payload(kind: str, n: int, seed: int = 0) -> bytes:
    """The payload recipe of tests/test_device_zstd.py."""
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
    if kind == "high":
        return bytes(128 + rng.randrange(128) for _ in range(n))
    if kind == "mixed":
        return (_payload("text", n // 2, seed)
                + _payload("random", n - n // 2, seed + 1))
    raise ValueError(kind)


# 2-4 KiB blocks (bucket B = 4096) of every kind, short and empty ones and
# a text block with many sequences
BLOCKS = ([_payload(k, 4096 - 512 * (s % 3), s) for s, k in enumerate(KINDS)]
          + [_payload("text", 777, 9), _payload("text", 2048, 12), b"",
             b"x", b"ab" * 3])


def _batch(blocks, width=B):
    arr = np.zeros((len(blocks), width), np.uint8)
    for i, b in enumerate(blocks):
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
    return arr, np.array([len(b) for b in blocks], np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def jz():
    """The JAX package's zstd encoder module (JAX on the CPU)."""
    from aocl_compression_tpu.ops import zstd_device
    return zstd_device


@pytest.fixture(scope="module")
def jax_mods():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _lit_rows():
    """Literal rows (N, 1024) of real shapes and the edges: no literals,
    one literal, one repeated symbol, all 256 symbols, skewed text."""
    rows, n = [], []
    for i, k in enumerate(KINDS):
        rows.append(np.frombuffer(_payload(k, 1024, i), np.uint8))
        n.append(1024 - 97 * i)
    rows += [np.zeros(1024, np.uint8), np.full(1024, 7, np.uint8),
             np.full(1024, 7, np.uint8), np.arange(1024, dtype=np.uint8)]
    n += [0, 1, 1024, 1024]
    return np.stack(rows).astype(np.int32), np.array(n, np.int32)


def test_block_huffman(jz, jax_mods):
    jax, jnp = jax_mods
    lits, n = _lit_rows()
    ref = jax.jit(jax.vmap(functools.partial(jz._block_huffman, B=1024)))(
        jnp.asarray(lits), jnp.asarray(n))
    got = tdev._block_huffman(_t(lits), _t(n))
    for port, r in zip(got, ref):
        _eq(port, r)
    assert got[3][:6].all() and not got[3][6]   # no literals: one symbol


def test_encode_weights(jz, jax_mods):
    """Weights of real tables and random rows over the whole 0..11 range,
    against the JAX function and the scalar oracle."""
    jax, jnp = jax_mods
    lits, n = _lit_rows()
    w = tdev._block_huffman(_t(lits), _t(n))[2].numpy()
    rng = np.random.default_rng(3)
    w = np.concatenate([w, rng.integers(0, 12, (6, 255))]).astype(np.int32)
    jb, js = jax.jit(jax.vmap(jz._encode_weights))(jnp.asarray(w))
    buf, size = tdev._encode_weights(_t(w))
    _eq(buf, jb)
    _eq(size, js)
    for i in range(len(w)):
        assert buf[i, :size[i]].numpy().tobytes() == \
            ZF.encode_weight_stream(w[i].tolist())


def _counts(seed):
    """(N, 64) histograms: empty, one symbol, two, ties of remainders,
    skewed and flat rows, codes past the predefined tables."""
    rng = np.random.default_rng(seed)
    rows = [np.zeros(64), np.eye(64)[5] * 40, np.eye(64)[0] + np.eye(64)[35],
            np.full(64, 3), np.r_[np.full(7, 11), np.zeros(57)]]
    for _ in range(11):
        h = np.zeros(64)
        k = rng.integers(2, 53)
        h[rng.choice(53, k, replace=False)] = rng.integers(
            1, 900, k) ** rng.integers(1, 3) % 8000 + 1
        rows.append(h)
    return np.array(rows, np.int32)


@pytest.mark.parametrize("L", [9, 8])
def test_normalize_counts_and_tables(jz, jax_mods, L):
    jax, jnp = jax_mods
    counts = _counts(L)
    jn, jok = jax.jit(jax.vmap(lambda c: jz._normalize_counts(c, L)))(
        jnp.asarray(counts))
    norm, ok = tdev._normalize_counts(_t(counts), L)
    _eq(norm, jn)
    _eq(ok, jok)
    assert not ok[0] and not ok[1] and ok[2:].all()
    good = norm[ok]
    ref = jax.jit(jax.vmap(lambda x: jz._fse_encode_tables(x, L)))(
        jnp.asarray(good.numpy()))
    got = tdev._fse_encode_tables(good, L)
    for port, r in zip(got, ref):
        _eq(port, r)
    # the scalar table builder (FSE_buildCTable semantics) agrees
    for i, row in enumerate(good.tolist()):
        last = max(s for s, v in enumerate(row) if v)
        nxt, tt = ZF.fse_build_encode(row[:last + 1], L)
        assert got[0][i, :1 << L].tolist() == nxt
        assert [(int(a), int(b)) for a, b in zip(got[1][i, :last + 1],
                                                 got[2][i, :last + 1])] == tt


@pytest.mark.parametrize("field", ["ll", "ml", "of"])
def test_choose_seq_table(jz, jax_mods, field):
    """Codes of random blocks, with and without a skew that makes custom
    tables cheaper, at nseq around the 32-sequence gate."""
    jax, jnp = jax_mods
    L, nsym = {"ll": (9, 36), "ml": (9, 53), "of": (8, 29)}[field]
    cost = {"ll": jz.LL_COST, "ml": jz.ML_COST, "of": jz.OF_COST}[field]
    rng = np.random.default_rng(L + nsym)
    MAXSEQ = 96
    nseq = np.array([0, 5, 31, 32, 33, 60, 96, 96, 80, 40, 64, 96],
                    np.int32)
    codes = rng.integers(0, min(nsym, 32), (len(nseq), MAXSEQ))
    codes[6:9] = rng.integers(0, 3, (3, MAXSEQ))        # skewed: custom wins
    codes[9] = 7                                         # one symbol
    codes = codes.astype(np.int32)
    real = np.arange(MAXSEQ)[None] < nseq[:, None]
    fn = jax.vmap(lambda c, r, n: jz._choose_seq_table(c, r, n, L, cost,
                                                       nsym))
    ref = jax.jit(fn)(jnp.asarray(codes), jnp.asarray(real),
                      jnp.asarray(nseq))
    got = tdev._choose_seq_table(_t(codes), _t(real), _t(nseq), L,
                                 _t(cost), nsym)
    _eq(got[0], ref[0])
    assert got[0].any() and not got[0].all()
    for port, r in zip(got[1:], ref[1:]):
        _eq(port, r)


def _scalar_pieces(xs, ns, nxt, dnb, dfs):
    """The FSE scan of one block in Python ints: step r encodes sequence
    ns - 1 - r with fields [ll, ml, of]; rows of [of, ml, ll state bits,
    ll, ml, of extras] values and widths, and the final states."""
    st = [0, 0, 0]
    pv, pn = [], []
    for r in range(ns):
        x = xs[ns - 1 - r]
        code = {0: x[0], 1: x[3], 2: x[6]}
        vals, nbs = {}, {}
        for f in (2, 1, 0):
            c = code[f]
            if r == 0:
                nbout = (dnb[f][c] + (1 << 15)) >> 16
                st[f] = nxt[f][(((nbout << 16) - dnb[f][c]) >> nbout)
                               + dfs[f][c]]
                vals[f] = nbs[f] = 0
            else:
                nb = (st[f] + dnb[f][c]) >> 16
                vals[f], nbs[f] = st[f] & ((1 << nb) - 1), nb
                st[f] = nxt[f][(st[f] >> nb) + dfs[f][c]]
        pv.append([vals[2], vals[1], vals[0], x[1], x[4], x[7]])
        pn.append([nbs[2], nbs[1], nbs[0], x[2], x[5], x[6]])
    return pv, pn, st


@functools.lru_cache(maxsize=None)
def _scan_inputs(level):
    """The FSE scan's inputs of a real encode of BLOCKS (CPU), captured at
    the call."""
    seen = []
    orig = tdev._fse_scan

    def capture(*args):
        seen.append(args)
        return orig(*args)

    tdev._fse_scan = capture
    try:
        tdev.encode_blocks(BLOCKS, level, device="cpu")
    finally:
        tdev._fse_scan = orig
    return seen[0]


@pytest.mark.parametrize("level", [1, 3])
def test_fse_scan_plain_matches_scalar_walk(level):
    xs, nseq, nxt, dnb, dfs = _scan_inputs(level)
    pv, pn, fin = tdev._fse_scan_plain(xs, nseq, nxt, dnb, dfs)
    assert int(nseq.max()) > 100
    for i in range(xs.shape[0]):
        ns = int(nseq[i])
        ev, en, est = _scalar_pieces(xs[i].tolist(), ns, nxt[i].tolist(),
                                     dnb[i].tolist(), dfs[i].tolist())
        assert pv[i, :ns].tolist() == ev and pn[i, :ns].tolist() == en
        assert not pv[i, ns:].any() and not pn[i, ns:].any()
        assert fin[i].tolist() == est


_FSE_ADVERSARIAL = ["nseq_edges", "codes_negative", "codes_outside",
                    "tables_wild"]


def _fse_adversarial(case, rng):
    """The FSE scan's inputs (xs, nseq, nxt, dnb, dfs) of the level-1 encode
    of BLOCKS as numpy arrays, made corrupt or edgy: nseq of 0, 1, MAXSEQ
    and below 0 (the rows past a block's own count copy its real rows);
    codes c - 64, which count from the end of a table to code c; codes far
    outside [0, 64); dnb / dfs / nxt values that drive next-state indices
    outside [0, 512) and bit counts outside [0, 32), sums that wrap."""
    xs, nseq, nxt, dnb, dfs = (a.numpy().copy() for a in _scan_inputs(1))
    N, MAXSEQ, _ = xs.shape
    if case == "nseq_edges":
        for i in range(N):
            if nseq[i] > 0:
                xs[i, nseq[i]:] = xs[i, rng.integers(0, nseq[i],
                                                     MAXSEQ - nseq[i])]
        nseq[:] = rng.integers(0, MAXSEQ + 1, N)
        nseq[:4] = [0, 1, MAXSEQ, -3]
    elif case in ("codes_negative", "codes_outside"):
        for col in (0, 3, 6):
            hit = rng.random((N, MAXSEQ)) < 0.25
            wild = (xs[:, :, col] - 64 if case == "codes_negative"
                    else rng.integers(-300, 300, (N, MAXSEQ)))
            xs[:, :, col] = np.where(hit, wild, xs[:, :, col])
    elif case == "tables_wild":
        def wild(a, small):
            pick = rng.integers(0, 3, a.shape)
            return np.select([pick == 0, pick == 1], [
                rng.integers(-2**31, 2**31, a.shape),
                rng.integers(-small, small, a.shape)], a).astype(np.int32)
        dnb, dfs = wild(dnb, 1 << 22), wild(dfs, 2048)
        nxt = wild(nxt, 1 << 17)
    return xs, nseq, nxt, dnb, dfs


@pytest.mark.parametrize("case", ["nseq_edges", "codes_negative"])
def test_fse_scan_plain_adversarial_matches_scalar_walk(case):
    """The plain scan on edge counts and negative codes, where the scalar
    walk (Python indexing counts a negative index from the end, as the
    scan's tab_index does) is defined."""
    rng = np.random.default_rng(_FSE_ADVERSARIAL.index(case))
    xs, nseq, nxt, dnb, dfs = _fse_adversarial(case, rng)
    pv, pn, fin = tdev._fse_scan_plain(*map(torch.from_numpy,
                                            (xs, nseq, nxt, dnb, dfs)))
    for i in range(xs.shape[0]):
        ns = max(int(nseq[i]), 0)
        ev, en, est = _scalar_pieces(xs[i].tolist(), ns, nxt[i].tolist(),
                                     dnb[i].tolist(), dfs[i].tolist())
        assert pv[i, :ns].tolist() == ev and pn[i, :ns].tolist() == en
        assert not pv[i, ns:].any() and not pn[i, ns:].any()
        assert fin[i].tolist() == est


@pytest.mark.parametrize("G", [4, 0])
def test_make_encoder(jz, jax_mods, G):
    """Every output of the batched encoder: streams, sizes, literals,
    sections, Huffman descriptions, table flags and norms."""
    jax, jnp = jax_mods
    arr, lens = _batch(BLOCKS)
    ref = jz.make_encoder(B, G)(jnp.asarray(arr), jnp.asarray(lens))
    got = tdev.make_encoder(B, G)(_t(arr), _t(lens))
    assert len(got) == len(ref) == 12
    for port, r in zip(got, ref):
        _eq(port, r)
    assert got[10].any()   # some block took a custom FSE table


def _stock_decode(frames, blocks):
    zstandard = pytest.importorskip("zstandard")
    d = zstandard.ZstdDecompressor()
    for f, b in zip(frames, blocks):
        assert d.decompress(f, max_output_size=len(b) + 64) == b


@pytest.mark.parametrize("level", [1, 3])
def test_encode_blocks(jz, level):
    from aocl_compression_tpu_torch.ops import zstd_decode_device
    frames, dlens = tdev.encode_blocks(BLOCKS, level, device="cpu")
    assert dlens == [len(b) for b in BLOCKS]
    jframes = jz.encode_blocks(BLOCKS, level)[0]
    assert frames == jframes
    # the port's device decoder reads the JAX package's frames
    assert zstd_decode_device.decode_chunks(
        jframes, dlens, device="cpu",
        host_decode=native.zstd_decompress) == BLOCKS
    assert native.zstd_decompress(b"".join(frames)) == b"".join(BLOCKS)
    _stock_decode(frames, BLOCKS)


def test_encode_blocks_64k(jz):
    """One 64 KiB block and a short one at level 1 (the tier's block size:
    MAXSEQ 8,194, the compaction at 23,040 and 82,432-byte rows)."""
    blocks = [_payload("mixed", 65536, 4)[:40000] + _payload("text", 25536),
              _payload("high", 3000, 5)]
    frames = tdev.encode_blocks(blocks, 1, device="cpu")[0]
    assert frames == jz.encode_blocks(blocks, 1)[0]
    assert native.zstd_decompress(b"".join(frames)) == b"".join(blocks)


def test_caps_and_tables_are_the_jax_packages(jz):
    assert tdev.stream_cap(65536) == jz.stream_cap(65536) == 23040
    assert tdev.seq_cap(8194) == jz.seq_cap(8194) == 82432
    c = tdev._consts(torch.device("cpu"))
    for name, ref in (("ll_nxt", jz.LLN_P), ("ml_dnb", jz.MLDNB_P),
                      ("of_dfs", jz.OFDFS_P), ("w_nxt", jz.WN),
                      ("ll_cost", jz.LL_COST), ("ml_cost", jz.ML_COST)):
        _eq(c[name], ref)
    from aocl_compression_tpu.codecs import zstd_format as JZF
    assert ZF.WEIGHT_DESC == JZF.WEIGHT_DESC


# --- card-only: the FSE scan kernel against its plain loop -------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 3])
def test_fse_encode_kernel_matches_plain(cuda_device, level):
    from aocl_compression_tpu_torch.ops import zstd_scan
    args = _scan_inputs(level)
    want = tdev._fse_scan_plain(*args)
    n0 = zstd_scan.launches["fse_encode_scan"]
    got = tdev._fse_scan(*(a.to(cuda_device) for a in args))
    torch.cuda.synchronize()
    assert zstd_scan.launches["fse_encode_scan"] == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _FSE_ADVERSARIAL)
def test_fse_encode_kernel_matches_plain_adversarial(cuda_device, case):
    """fse_encode_scan against its plain loop, every output (exact), on
    edge counts, codes outside [0, 64) and wild tables."""
    rng = np.random.default_rng(_FSE_ADVERSARIAL.index(case))
    args = [torch.from_numpy(a) for a in _fse_adversarial(case, rng)]
    want = tdev._fse_scan_plain(*args)
    got = tdev._fse_scan(*(a.to(cuda_device) for a in args))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_encode_blocks_on_card_matches_cpu(cuda_device):
    blocks = BLOCKS + [_payload("text", 65536, 8)]
    for level in (1, 3):
        assert tdev.encode_blocks(blocks, level, device=cuda_device) == \
            tdev.encode_blocks(blocks, level, device="cpu")
