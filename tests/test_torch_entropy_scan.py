"""The encoders' entropy-table scans (ops/entropy_scan.py, csrc/
entropy_scan.cu) and their plain loops against the JAX package.

On the CPU the port's _kraft_lengths (zlib level 2, 288 and 32 symbols),
_block_huffman (zstd, 256 symbols) and _encode_weights run the plain loops
(_kraft_absorb_plain, _encode_weights_plain); the same seeded numpy rows go
through the JAX functions (jitted and vmapped on the CPU). The rows include
the edges: no symbol, one present symbol, all symbols present, all-equal
counts, a 65,536-count symbol whose share wraps negative in int32, and rows
whose Kraft absorb fails (ok False). Tolerance: exact equality on every
output (nb, ok, code, weights, buf, size).

The JAX package is imported inside fixtures, so the card-only tests (the
kernels against the plain loops) also run where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_entropy_scan.py
"""

import functools
import zlib

import numpy as np
import pytest
import torch

from aocl_compression_tpu_torch.codecs import zstd_format as ZF
from aocl_compression_tpu_torch.ops import deflate_device as ddev
from aocl_compression_tpu_torch.ops import zstd_device as zdev

ZB = 4096   # literal rows of the zstd cases


@pytest.fixture(scope="module")
def jax_mods():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(port, ref):
    np.testing.assert_array_equal(port.cpu().numpy(), np.asarray(ref))


def _kraft_fail_counts():
    """Counts 2^15 .. 2^6 and 64 ones (total 2^16): every share is a power
    of two or 0, so the lengths' Kraft sum passes 1 (D starts at -32) and
    the absorb cannot repair it."""
    return [1 << e for e in range(15, 5, -1)] + [1] * 64


def _hists(nsym: int, seed: int) -> np.ndarray:
    """(rows, nsym) int32 histograms: the edges, then seeded random rows
    and a text's byte histogram (288 symbols)."""
    rng = np.random.default_rng(seed)
    rows = [np.zeros(nsym), np.eye(nsym)[3] * 5,            # none, one
            np.eye(nsym)[0] + np.eye(nsym)[nsym - 1] * 9,   # two
            rng.integers(1, 3000, nsym),                    # all present
            np.full(nsym, 250)]                             # all equal
    wrap = np.zeros(nsym)
    wrap[[1, 7, nsym - 2]] = [65536, 3, 1]                  # share wraps
    rows.append(wrap)
    big = np.zeros(nsym)
    big[[0, 5]] = [70000, 70000]
    rows.append(big)
    if nsym >= 74:
        fail = np.zeros(nsym)
        fail[rng.choice(nsym, 74, replace=False)] = _kraft_fail_counts()
        rows.append(fail)
    for _ in range(10):
        k = rng.integers(2, nsym + 1)
        h = np.zeros(nsym)
        h[rng.choice(nsym, k, replace=False)] = rng.integers(
            1, 4000, k) ** rng.integers(1, 3)
        rows.append(h)
    if nsym == 288:
        text = np.frombuffer(b"the block hash match stream of a window "
                             * 1600, np.uint8)
        h = np.bincount(text, minlength=288).astype(np.float64)
        h[256] += 1
        h[257:270] += rng.integers(0, 300, 13)
        rows.append(h)
    return np.array(rows, np.int32)


@pytest.mark.parametrize("nsym", [288, 32])
def test_kraft_lengths_matches_jax(jax_mods, nsym):
    from aocl_compression_tpu.ops import deflate_device as jdev
    jax, jnp = jax_mods
    hist = _hists(nsym, nsym)
    jnb, jok = jax.jit(jax.vmap(functools.partial(
        jdev._kraft_lengths, NSYM=nsym)))(jnp.asarray(hist))
    nb, ok = ddev._kraft_lengths(_t(hist), nsym)
    _eq(nb, jnb)
    _eq(ok, jok)
    assert not ok[0] and not ok[1] and ok[2:7].all()
    if nsym == 288:
        assert not ok[7]   # the Kraft sum past 1


def _lit_rows(seed: int = 7):
    """(rows, ZB) int32 literal rows and their counts: no literals, one
    literal, one symbol repeated, all 256 symbols (equal counts), 64 equal
    counts, the Kraft-failing shares (counts 2^11 .. 2^1 and two ones,
    symbol 255 among the ones), seeded random and skewed rows."""
    rng = np.random.default_rng(seed)
    rows, n = [], []

    def add(vals, k=None):
        r = np.zeros(ZB, np.int32)
        r[:len(vals)] = vals
        rows.append(r)
        n.append(len(vals) if k is None else k)

    add([], 0)
    add([9])
    add(np.full(ZB, 7))
    add(rng.permutation(np.arange(ZB) % 256))
    add(np.arange(ZB) % 64)
    fail = np.concatenate([np.full(1 << e, e) for e in range(11, 0, -1)]
                          + [[100, 255]])
    add(rng.permutation(fail))
    add(rng.integers(0, 256, ZB))
    add(rng.integers(0, 256, ZB) ** 2 % 256, 3000)
    add(np.minimum(rng.geometric(0.05, ZB), 255))
    add(np.minimum(rng.geometric(0.3, ZB), 255), 1234)
    return np.stack(rows).astype(np.int32), np.array(n, np.int32)


def test_block_huffman_matches_jax(jax_mods):
    from aocl_compression_tpu.ops import zstd_device as jz
    jax, jnp = jax_mods
    lits, n = _lit_rows()
    ref = jax.jit(jax.vmap(functools.partial(jz._block_huffman, B=ZB)))(
        jnp.asarray(lits), jnp.asarray(n))
    got = zdev._block_huffman(_t(lits), _t(n))
    for port, r in zip(got, ref):
        _eq(port, r)
    # no literals: one symbol; 64 equal counts and the forced symbol 255
    # (share 0, one more unit) pass the Kraft sum, as the failing shares do
    assert got[3].tolist() == [False, True, True, True, False, False, True,
                               True, True, True]


def _weight_rows(seed: int = 9):
    """(rows, 255) int32 weights: real tables of _lit_rows' Kraft-exact
    rows, the edges (all 0, all 11, alternating 0 / 11, a ramp) and seeded
    random rows over the table's 12 symbols."""
    lits, n = _lit_rows()
    _, _, w, ok = zdev._block_huffman(_t(lits), _t(n))
    rng = np.random.default_rng(seed)
    edge = [np.zeros(255), np.full(255, 11), np.arange(255) % 2 * 11,
            np.arange(255) % 12]
    return np.concatenate([w.numpy()[ok.numpy()], np.array(edge),
                           rng.integers(0, 12, (8, 255))]).astype(np.int32)


def test_encode_weights_matches_jax(jax_mods):
    from aocl_compression_tpu.ops import zstd_device as jz
    jax, jnp = jax_mods
    w = _weight_rows()
    jb, js = jax.jit(jax.vmap(jz._encode_weights))(jnp.asarray(w))
    buf, size = zdev._encode_weights(_t(w))
    _eq(buf, jb)
    _eq(size, js)
    for i in range(len(w)):
        assert buf[i, :size[i]].numpy().tobytes() == \
            ZF.encode_weight_stream(w[i].tolist())


def test_scans_reject_other_devices():
    """The dispatch takes the kernel for CUDA, the plain loop for the CPU,
    and raises on any other device."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ddev._kraft_absorb(torch.zeros((2, 32), dtype=torch.int32,
                                       device=meta),
                           torch.zeros(2, dtype=torch.int32, device=meta), 15)
    with pytest.raises(ValueError, match="unsupported device"):
        zdev._encode_weights(torch.zeros((2, 255), dtype=torch.int32,
                                         device=meta))


def test_kraft_absorb_plain_hand_rows():
    """The plain absorb on hand-worked rows: D = 5 over lengths [3, 3, 0]
    at MAXLEN 3 (c = 1; q = 6, k = 2, D = 2; q = 3, k = 1, D = 1); a
    negative D stays."""
    nbs = _t([[3, 3, 0], [2, 1, 0]]).to(torch.int32)
    nbs2, D = ddev._kraft_absorb(nbs, _t([5, -3]).to(torch.int32), 3)
    assert nbs2.tolist() == [[1, 2, 0], [2, 1, 0]]
    assert D.tolist() == [1, -3]


# --- the kernels' algorithms, as numpy models, against the plain loops --------

I32MAX = (1 << 31) - 1


def _absorb_runs(nbs, D, maxlen):
    """numpy model of kraft_absorb's run walk (csrc/entropy_scan.cu), step
    for step as the kernel takes it: the runs of equal length listed in
    order; per run (while D > 0) a = D >> sh, b = a + 1, the capped steps
    (k = nb - 1) counted by one division and cut at the run's end, then
    single steps with k = floor(log2 b) until b = 1, D = (b - 1) * 2^sh + r;
    a run of nb <= 1, or whose a + 1 wraps int32, changes nothing. The walk
    leaves each position's k (0 where it took no step); every position then
    takes nb - k."""
    nbs = np.asarray(nbs, np.int64)
    out = nbs.copy()
    dout = np.asarray(D, np.int64).copy()
    for i, row in enumerate(nbs):
        nsym = len(row)
        starts = [0] + [j for j in range(1, nsym) if row[j] != row[j - 1]]
        rs = starts + [nsym]
        kk = np.zeros(nsym, np.int64)
        d = int(dout[i])
        for r in range(len(starts)):
            if d <= 0:
                break
            s, e, v = rs[r], rs[r + 1], int(row[rs[r]])
            cap, sh = v - 1, maxlen - v
            a = d >> sh
            if cap <= 0 or a == I32MAX:
                continue
            b, top = a + 1, 1 << cap
            j = s
            if b >= top:
                m = min((b - top) // (top - 1) + 1, e - s)
                b -= m * (top - 1)
                kk[s:s + m] = cap
                j += m
            while j < e and b > 1:
                k = b.bit_length() - 1
                kk[j] = k
                b -= (1 << k) - 1
                j += 1
            d = ((b - 1) << sh) + (d & ((1 << sh) - 1))
        out[i] = row - kk
        dout[i] = d
    return out.astype(np.int32), dout.astype(np.int32)


def _d_edges(maxlen, n, rng):
    """n deficits: the edges (-2^MAXLEN, -1, 0, 1, 2, 2^MAXLEN - 1,
    2^MAXLEN), then seeded values in [-2^MAXLEN, 2^MAXLEN]."""
    top = 1 << maxlen
    edge = [-top, -1, 0, 1, 2, top - 1, top]
    return np.array((edge + list(rng.integers(-top, top + 1, n)))[:n],
                    np.int64)


def _absorb_case(case):
    """(nbs (rows, NSYM) int32, D (rows,) int32, MAXLEN) of one case."""
    rng = np.random.default_rng(zlib.crc32(str(case).encode()))
    if case == "hand":   # test_kraft_absorb_plain_hand_rows' rows and more
        nbs = [[3, 3, 0], [2, 1, 0], [3, 3, 3], [1, 2, 3], [3, 2, 2]]
        return (np.array(nbs, np.int32), np.array([5, -3, 7, 8, 3],
                                                  np.int32), 3)
    if case == "short runs":   # capped counts past their runs' ends
        rows = [[9, 9, 10, 10, 11, 11, 12, 13, 15, 15, 0, 0],
                [15, 15, 15, 14, 14, 2, 2, 1, 0, 0, 0, 0],
                [2, 3, 3, 4, 4, 4, 4, 5, 5, 6, 7, 0]]
        nbs = np.repeat(np.array(rows), 8, axis=0)
        D = np.tile([1 << 15, (1 << 15) - 3, 40000, 1 << 14, 5000, 977,
                     65535, 3], 3)
        return nbs.astype(np.int32), D.astype(np.int32), 15
    if case == "one run":
        nbs = np.repeat(np.arange(1, 12)[:, None], 40, axis=1)
        nbs = np.repeat(nbs, 4, axis=0)
        D = np.tile([1 << 11, 1000, 0, -5], 11)
        return nbs.astype(np.int32), D.astype(np.int32), 11
    if case == "zeros":
        return (np.zeros((7, 64), np.int32),
                _d_edges(15, 7, rng).astype(np.int32), 15)
    if case[0] == "pool":   # the card tests' rows
        return (*_absorb_pool(*case[1:]), case[2])
    if case == "int32 edge":   # (D >> 0) + 1 wraps: no step
        nbs = np.array([[15, 15, 14, 3, 0], [14, 15, 15, 15, 0],
                        [1, 2, 15, 15, 15]], np.int32)
        D = np.array([I32MAX, I32MAX, I32MAX], np.int32)
        return nbs, D, 15
    nsym, maxlen, order = case
    rows = []
    for i in range(48):
        present = int(rng.integers(1, nsym + 1))
        lens = rng.integers(1, maxlen + 1, present)
        if i % 3 == 0:   # skewed towards long codes, as real tables are
            lens = np.minimum(maxlen, lens + rng.integers(0, maxlen, present))
        row = np.zeros(nsym, np.int64)
        row[:present] = np.sort(lens)
        if order == "unsorted":
            row = rng.permutation(row)
        rows.append(row)
    return (np.array(rows, np.int32),
            _d_edges(maxlen, len(rows), rng).astype(np.int32), maxlen)


POOL_SHAPES = [(288, 15), (32, 15), (256, 11), (1, 11), (37, 15),
               (383, 30), (3778, 15)]


def _absorb_pool(nsym, maxlen, rows=260):
    """(nbs (rows, nsym), D (rows,)) int32, seeded: rows sorted as the
    callers sort them (some skewed towards long codes), unsorted rows,
    rows of one run and all-zero rows, in turn; D at the edges
    (_d_edges), every 37th 2^31 - 1."""
    rng = np.random.default_rng(nsym * 31 + maxlen)
    nbs = np.zeros((rows, nsym), np.int64)
    for i in range(rows):
        present = int(rng.integers(1, nsym + 1))
        lens = rng.integers(1, maxlen + 1, present)
        if i % 5 == 0:
            lens = np.minimum(maxlen, lens + rng.integers(0, maxlen, present))
        nbs[i, :present] = np.sort(lens)
        if i % 5 == 1:
            nbs[i] = rng.permutation(nbs[i])
        elif i % 5 == 2:
            nbs[i] = rng.integers(1, maxlen + 1)
        elif i % 5 == 3 and i % 2:
            nbs[i] = 0
    D = _d_edges(maxlen, rows, rng)
    D[::37] = I32MAX
    return nbs.astype(np.int32), D.astype(np.int32)


ABSORB_CASES = ([(nsym, maxlen, order) for nsym in (1, 32, 256, 288)
                 for maxlen in (11, 15) for order in ("sorted", "unsorted")]
                + ["hand", "short runs", "one run", "zeros", "int32 edge"]
                + [("pool", nsym, maxlen) for nsym, maxlen in POOL_SHAPES])


@pytest.mark.parametrize("case", ABSORB_CASES, ids=str)
def test_run_walk_matches_plain(case):
    """The run walk of kraft_absorb (a numpy model mirroring the kernel)
    equals the plain step-by-step loop exactly: nbs2 and D."""
    nbs, D, maxlen = _absorb_case(case)
    want_nb, want_d = ddev._kraft_absorb_plain(_t(nbs), _t(D), maxlen)
    got_nb, got_d = _absorb_runs(nbs, D, maxlen)
    np.testing.assert_array_equal(got_nb, want_nb.numpy())
    np.testing.assert_array_equal(got_d, want_d.numpy())
    if case == "short runs":   # the capped counts did pass the run ends
        assert (got_nb[:, :2] == 1).any()


def _weights_two_lanes(w, nxt, dnb, dfs):
    """numpy model of weights_fse_encode (csrc/entropy_scan.cu): the next-
    state table by symbol and state, state 1 on one lane (init at 254,
    steps 252, 250, ..., 0) and state 2 on another (init 253, steps 251,
    ..., 1), each saving the state it starts from; then the 256 fields in
    stream order (the step at 252 - f, state 2 and state 1 less 64 in 6
    bits, the closing bit), 8 a lane, placed by a prefix sum of widths and
    ORed into 128 little-endian words."""
    nxt, dnb, dfs = (np.asarray(t, np.int64) for t in (nxt, dnb, dfs))
    st = np.arange(64, 128)[None, :]
    width = (st + dnb[:, None]) >> 16
    nxt_tab = nxt[(st >> width) + dfs[:, None]] - 64
    nbout = (dnb + (1 << 15)) >> 16
    init = nxt[(((nbout << 16) - dnb) >> nbout) + dfs] - 64
    bufs, sizes = [], []
    for row in np.asarray(w, np.int64):
        rec = np.zeros(256, np.int64)
        fin = [0, 0]
        for lane in (0, 1):
            s = init[row[254 - lane]]
            for idx in range(252 - lane, -1, -2):
                rec[idx] = s
                s = nxt_tab[row[idx], s]
            fin[lane] = s
        vals, widths = [], []
        for f in range(256):
            if f <= 252:
                s = 64 + rec[252 - f]
                nb = (s + dnb[row[252 - f]]) >> 16
                vals.append(s & ((1 << nb) - 1))
                widths.append(nb)
            else:
                vals.append(1 if f == 255 else fin[254 - f])
                widths.append(1 if f == 255 else 6)
        pos = np.cumsum([0] + widths)
        words = [0] * 128
        for lane in range(32):
            p = int(pos[8 * lane])
            acc = 0
            for i in range(8):
                acc |= int(vals[8 * lane + i]) << int(pos[8 * lane + i] - p)
            acc <<= p & 31
            for q in range(4):
                if (p >> 5) + q < 128:
                    words[(p >> 5) + q] |= (acc >> (32 * q)) & 0xFFFFFFFF
        bufs.append(np.array(words, "<u4").view(np.uint8))
        sizes.append((int(pos[255]) + 1 + 7) >> 3)
    return np.stack(bufs), np.array(sizes, np.int32)


def test_two_lane_pack_matches_plain():
    """The weight encode's two chains and its packing afterwards (a numpy
    model mirroring the kernel) equal the plain loop exactly: buf and
    size, on this file's weight rows and seeded random ones."""
    c = zdev._consts(torch.device("cpu"))
    w = np.concatenate([_weight_rows(), np.random.default_rng(11).integers(
        0, 12, (16, 255))]).astype(np.int32)
    want_buf, want_size = zdev._encode_weights_plain(_t(w))
    buf, size = _weights_two_lanes(w, c["w_nxt"], c["w_dnb"], c["w_dfs"])
    np.testing.assert_array_equal(buf, want_buf.numpy())
    np.testing.assert_array_equal(size, want_size.numpy())


def test_static_weight_table_closed():
    """Enumerated: for every state in [64, 127] and each of the static
    table's 12 symbols the encode index (st >> nb) + dfs lies in [0, 63]
    with nb = (st + dnb) >> 16 in [0, 9]; each symbol's init index lies in
    [0, 63]; every next state in [64, 127]. So the kernel's chain needs no
    clamp, and table_closed says so."""
    from aocl_compression_tpu_torch.ops import entropy_scan
    c = zdev._consts(torch.device("cpu"))
    nxt, dnb, dfs = (c[k].tolist() for k in ("w_nxt", "w_dnb", "w_dfs"))
    assert len(dnb) == 12 and len(nxt) == 64
    assert all(64 <= x <= 127 for x in nxt)
    for d, f in zip(dnb, dfs):
        for st in range(64, 128):
            nb = (st + d) >> 16
            assert 0 <= nb <= 9 and 0 <= (st >> nb) + f <= 63
        nbout = (d + (1 << 15)) >> 16
        assert 0 <= (((nbout << 16) - d) >> nbout) + f <= 63
    assert entropy_scan.table_closed(c["w_nxt"], c["w_dnb"], c["w_dfs"])


@pytest.mark.parametrize("opening", ["nxt below 64", "nxt past 127",
                                     "index past 63", "index below 0",
                                     "width past 9", "in-place edit"])
def test_weights_wrapper_raises_on_open_table(opening):
    """weights_fse_encode raises on a table that is not closed (before it
    looks at the device); a closed one gets past the proof to the device
    check, and a table edited in place after its proof is proven anew."""
    from aocl_compression_tpu_torch.ops import entropy_scan
    c = zdev._consts(torch.device("cpu"))
    nxt, dnb, dfs = (c[k].clone() for k in ("w_nxt", "w_dnb", "w_dfs"))
    w = torch.zeros((2, 255), dtype=torch.int32)
    if opening == "in-place edit":
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            entropy_scan.weights_fse_encode(w, nxt, dnb, dfs)
        nxt[5] = 128
    elif opening == "nxt below 64":
        nxt[0] = 63
    elif opening == "nxt past 127":
        nxt[63] = 128
    elif opening == "index past 63":
        dfs[11] += 64
    elif opening == "index below 0":
        dfs[0] -= 64
    else:
        dnb[3] += 10 << 16
    assert not entropy_scan.table_closed(nxt, dnb, dfs)
    with pytest.raises(ValueError, match="not closed"):
        entropy_scan.weights_fse_encode(w, nxt, dnb, dfs)


# --- card-only: the kernels against their plain loops ------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _absorb_args(monkeypatch, nsym, maxlen):
    """The (nbs, D) the port's scan gets from _kraft_lengths (nsym 288,
    32) or _block_huffman (256) on the CPU rows of this file."""
    module = zdev if nsym == 256 else ddev
    orig = module._kraft_absorb
    seen = []
    monkeypatch.setattr(module, "_kraft_absorb",
                        lambda *a: seen.append(a) or orig(*a))
    if nsym == 256:
        zdev._block_huffman(*(_t(a) for a in _lit_rows()))
    else:
        ddev._kraft_lengths(_t(_hists(nsym, nsym)), nsym)
    monkeypatch.undo()
    (nbs, D, m), = seen
    assert m == maxlen
    return nbs, D


@pytest.mark.cuda
@pytest.mark.parametrize("nsym,maxlen", [(288, 15), (32, 15), (256, 11)])
def test_kraft_absorb_kernel_matches_plain(cuda_device, monkeypatch, nsym,
                                           maxlen):
    from aocl_compression_tpu_torch.ops import entropy_scan
    nbs, D = _absorb_args(monkeypatch, nsym, maxlen)
    want = ddev._kraft_absorb_plain(nbs, D, maxlen)
    n0 = entropy_scan.launches["kraft_absorb"]
    got = ddev._kraft_absorb(nbs.to(cuda_device), D.to(cuda_device), maxlen)
    torch.cuda.synchronize()
    assert entropy_scan.launches["kraft_absorb"] == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_weights_fse_encode_kernel_matches_plain(cuda_device):
    from aocl_compression_tpu_torch.ops import entropy_scan
    w = _t(_weight_rows())
    want = zdev._encode_weights_plain(w)
    n0 = entropy_scan.launches["weights_fse_encode"]
    got = zdev._encode_weights(w.to(cuda_device))
    torch.cuda.synchronize()
    assert entropy_scan.launches["weights_fse_encode"] == n0 + 1
    for g, ww in zip(got, want):
        assert torch.equal(g.cpu(), ww)


@pytest.mark.cuda
def test_tables_on_card_match_cpu(cuda_device):
    """_kraft_lengths and _block_huffman whole, on the card against the
    CPU, one kernel launch each."""
    from aocl_compression_tpu_torch.ops import entropy_scan
    for nsym in (288, 32):
        h = _t(_hists(nsym, nsym))
        n0 = entropy_scan.launches["kraft_absorb"]
        got = ddev._kraft_lengths(h.to(cuda_device), nsym)
        assert entropy_scan.launches["kraft_absorb"] == n0 + 1
        for g, w in zip(got, ddev._kraft_lengths(h, nsym)):
            assert torch.equal(g.cpu(), w)
    lits, n = (_t(a) for a in _lit_rows())
    got = zdev._block_huffman(lits.to(cuda_device), n.to(cuda_device))
    for g, w in zip(got, zdev._block_huffman(lits, n)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("nsym,maxlen", POOL_SHAPES)
@pytest.mark.parametrize("n", [1, 31, 33, 257])
def test_kraft_absorb_kernel_pool_rows(cuda_device, nsym, maxlen, n):
    """The kernel on the first n pool rows (sorted, unsorted, one run, all
    zero; D at the edges and 2^31 - 1), one launch, equal to the plain
    loop; NSYM 1 and 37 take the scalar staging, 383 at MAXLEN 30 is the
    widest shape the kernel of one thread a row took, 3,778 the widest a
    warp's 48 KB of shared memory holds now."""
    from aocl_compression_tpu_torch.ops import entropy_scan
    nbs, D = (_t(a[:n]) for a in _absorb_pool(nsym, maxlen))
    want = ddev._kraft_absorb_plain(nbs, D, maxlen)
    n0 = entropy_scan.launches["kraft_absorb"]
    got = entropy_scan.kraft_absorb(nbs.to(cuda_device), D.to(cuda_device),
                                    maxlen)
    torch.cuda.synchronize()
    assert entropy_scan.launches["kraft_absorb"] == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 257])
def test_weights_fse_encode_kernel_rows(cuda_device, n):
    """The kernel on the first n of this file's weight rows and seeded
    random ones (rows of two warps' blocks, a ragged last block), one
    launch, equal to the plain loop."""
    from aocl_compression_tpu_torch.ops import entropy_scan
    w = _t(np.concatenate([_weight_rows(), np.random.default_rng(
        13).integers(0, 12, (257, 255))])[:n].astype(np.int32))
    want = zdev._encode_weights_plain(w)
    n0 = entropy_scan.launches["weights_fse_encode"]
    got = zdev._encode_weights(w.to(cuda_device))
    torch.cuda.synchronize()
    assert entropy_scan.launches["weights_fse_encode"] == n0 + 1
    for g, ww in zip(got, want):
        assert torch.equal(g.cpu(), ww)
