"""The sort-emit serializers (ops/emit_sorted.py, csrc/emit_sorted.cu) and
their plain versions against the JAX package.

On the CPU the port's _emit_sorted and _emit_snappy_sorted run their plain
versions (_emit_sorted_plain, _emit_snappy_sorted_plain). Seeded numpy rows
of 4,096 bytes go through the port's _find_matches and _grid_select (equal
to the JAX package's, tests/test_torch_lz4_device.py) at G = 2, 4 and 8;
the same tile parse goes through the JAX _emit_sorted and
_emit_snappy_sorted (jitted and vmapped on the CPU) and through the plain
versions. The rows hold what the kernels must not get wrong: a flagged row
of each format (a literal run of 256 bytes or more closed by a 4-byte
match), a row of such units end to end (flagged sequences all along; the
lz4 body runs past B), an all-literal row, an all-equal row, text, and a
padded last block (n < B, junk after n). Tolerance: none; identical bytes,
body, tail and flag on every row.

A numpy model of the kernels' design (the tile scans in chunks of threads
and warps with the carries between them, the next selected position from
each chunk's minimum, the occupancy bitmap, the ranks by its prefix count,
the list of irregular keys merged by rank) equals the plain versions on the
same rows and on seeded tile parses that no _grid_select gives (overlapping
sequences, so output positions collide; lengths below 4, offsets past a
byte), where the plain version's torch.sort is the reference.

The JAX package is imported inside a fixture, so the card-only tests (each
kernel against its plain version at N = 1, 3, 64 and 256 on the same kinds
of rows, flagged rows and the irregular parses included, at B = 4,096 and
65,536; no torch.sort and no other PyTorch op on the card) also run where
JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_emit_sorted.py
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from aocl_compression_tpu_torch.ops import lz4_device as tlz
from aocl_compression_tpu_torch.ops import snappy_device as tsn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
SMOKE = importlib.util.module_from_spec(_spec)    # its emit rows
_spec.loader.exec_module(SMOKE)

B = 4096
GRIDS = (2, 4, 8)
FORMATS = ("lz4", "snappy")
PLAIN = {"lz4": tlz._emit_sorted_plain, "snappy": tsn._emit_snappy_sorted_plain}
DISPATCH = {"lz4": tlz._emit_sorted, "snappy": tsn._emit_snappy_sorted}


rows = SMOKE.emit_rows            # seeded rows, flagged ones among them
tile_parse = SMOKE.emit_parse     # the encoders' tile parse at G
irregular = SMOKE.emit_irregular  # tile parses no _grid_select gives


# --- the JAX package (CPU) ------------------------------------------------

@pytest.fixture(scope="module")
def jax_emit():
    """fmt, G -> the JAX serializer jitted and vmapped on the CPU."""
    import jax

    from aocl_compression_tpu.ops import lz4_device as jlz
    from aocl_compression_tpu.ops import snappy_device as jsn
    fns = {}

    def get(fmt, G):
        if (fmt, G) not in fns:
            f = jlz._emit_sorted if fmt == "lz4" else jsn._emit_snappy_sorted
            fns[fmt, G] = jax.jit(jax.vmap(
                lambda d, n, s, p, l, o: f(d, n, s, p, l, o, B, G)))
        return fns[fmt, G]

    return get


@pytest.fixture(scope="module")
def staged():
    """G -> (rows, n, sel, cpos, cml, coff) as numpy arrays."""
    arr, lens = rows(B, seed=11)
    out = {}
    for G in GRIDS:
        parse = tile_parse(arr, lens, B, G)
        out[G] = (arr, lens) + tuple(x.numpy().copy() for x in parse)
    return out


def _plain(fmt, args, Bk, G):
    return [x.numpy() for x in PLAIN[fmt](
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), Bk, G)]


def _same(got, want, what):
    for name, g, w in zip(("out", "body", "tail", "flag"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what}: {name}")


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("G", GRIDS)
def test_plain_matches_jax(jax_emit, staged, fmt, G):
    args = staged[G]
    want = [np.asarray(x) for x in jax_emit(fmt, G)(*args)]
    got = _plain(fmt, args, B, G)
    _same(got, want, f"{fmt} G={G}")
    # the rows hold what they are meant to: flagged rows, an all-literal
    # row (no sequence)
    flag, body = got[3], got[1]
    assert flag[0] and flag[1] and not flag[2:4].any()
    assert body[2] == 0 and got[2][2] == B
    if fmt == "lz4":
        assert body[1] > B      # the flagged units' headers pass B


@pytest.mark.parametrize("fmt", FORMATS)
def test_dispatch(staged, fmt):
    """A CPU tensor takes the plain version, any other non-CUDA device
    raises."""
    args = [torch.from_numpy(a) for a in staged[4]]
    got = [x.numpy() for x in DISPATCH[fmt](*args, B, 4)]
    _same(got, _plain(fmt, staged[4], B, 4), f"{fmt} dispatch")
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        DISPATCH[fmt](*meta, B, 4)


# --- a numpy model of the kernels' design -----------------------------------

BIG, DUMMY = 1 << 20, 1 << 17
IMIN, IMAX = -(1 << 31), (1 << 31) - 1


def _nlx(lit):
    return np.where(lit < 15, 0, 1 + (lit - 15) // 255)


def _nmx(ml):
    return np.where(ml - 4 < 15, 0, 1 + (ml - 19) // 255)


def _lit_hdr(lit):
    return np.where(lit == 0, 0, np.where(lit <= 60, 1,
                                          np.where(lit <= 256, 2, 3)))


def _copy(ml, off):
    n64 = np.maximum(ml - 4, 0) >> 6
    l2 = ml - 64 * n64
    has60 = (l2 > 64).astype(np.int64)
    l3 = l2 - 60 * has60
    qual = (l3 < 12) & (off < 2048) & (l3 >= 4)
    ncopy = n64 + has60 + 1
    return n64, l3, qual, ncopy, 3 * (ncopy - 1) + np.where(qual, 2, 3)


def _size(fmt, lit, ml, off):
    """(sequence bytes, header bytes)."""
    if fmt == "lz4":
        hdr = 3 + _nlx(lit) + _nmx(ml)
    else:
        hdr = _lit_hdr(lit) + _copy(ml, off)[4]
    return hdr + lit, hdr


def _combine(a, b):
    """The kernel's associative scan of (sum, any, f1, f2, p1, p2)."""
    s, an, f1, f2, p1, p2 = a
    t, bn, g1, g2, q1, q2 = b
    return (s + t, an or bn, max(f1, g1), max(f2, g2),
            max(p1, f1, q1) if bn else p1, max(p2, f2, q2) if bn else p2)


ID = (0, False, 0, 0, 0, 0)


def _warp_scan(vals, op, lanes):
    """Hillis-Steele inclusive scan within warps of `lanes`."""
    inc = list(vals)
    d = 1
    while d < lanes:
        inc = [op(inc[j - d], inc[j]) if j % lanes >= d else inc[j]
               for j in range(len(inc))]
        d *= 2
    return inc


def model_tiles(fmt, sel, cpos, cml, coff, M, threads=16, lanes=4, R=4):
    """The kernel's tile phase for one row: each tile's (incl, posN, f1,
    f2, p1, p2), chunk by chunk, thread by thread."""
    chunk = threads * R
    nch = -(-M // chunk)
    cmin = [min((int(cpos[t]) if sel[t] else BIG)
                for t in range(c * chunk, min(M, (c + 1) * chunk)))
            for c in range(nch)]
    res = np.zeros((6, M), np.int64)
    ce_carry, carry = IMIN, ID
    nw = threads // lanes
    for c in range(nch):
        t0s = [c * chunk + j * R for j in range(threads)]
        real = [[t0 + r < M for r in range(R)] for t0 in t0s]
        tv = [[(bool(sel[t0 + r]), int(cpos[t0 + r]), int(cml[t0 + r]),
                int(coff[t0 + r])) if real[j][r] else (False, 0, 0, 0)
               for r in range(R)] for j, t0 in enumerate(t0s)]
        emax = [max([IMIN] + [p + l if s else 0 for (s, p, l, _), ok in
                              zip(tv[j], real[j]) if ok])
                for j in range(threads)]
        vmin = [min([IMAX] + [p if s else BIG for (s, p, _, _), ok in
                              zip(tv[j], real[j]) if ok])
                for j in range(threads)]
        einc = _warp_scan(emax, max, lanes)
        vinc = _warp_scan(vmin[::-1], min, lanes)[::-1]   # suffix in warps
        wmax = [einc[w * lanes + lanes - 1] for w in range(nw)]
        wmin = [vinc[w * lanes] for w in range(nw)]
        lits, sufs = [], []
        for j in range(threads):
            w, ln = divmod(j, lanes)
            ce = max([ce_carry, IMIN if ln == 0 else einc[j - 1]]
                     + wmax[:w])
            nx = min([IMAX if ln == lanes - 1 else vinc[j + 1]]
                     + wmin[w + 1:] + cmin[c + 1:])
            run, lit = ce, []
            for r, (s, p, l, _) in enumerate(tv[j]):
                lit.append(p - (0 if t0s[j] + r == 0 else run) if s else 0)
                if real[j][r]:
                    run = max(run, p + l if s else 0)
            lits.append(lit), sufs.append(nx)
        ce_carry = max([ce_carry] + wmax)
        locs = []
        for j in range(threads):
            loc = ID
            for r, (s, p, l, o) in enumerate(tv[j]):
                if s:
                    sz = int(_size(fmt, lits[j][r], l, o)[0])
                    q1 = (p << 16) | o
                    q2 = ((p + l - 1) << 16) | lits[j][r]
                    loc = _combine(loc, (sz, True, q1, q2, 0, 0))
            locs.append(loc)
        inc = _warp_scan(locs, _combine, lanes)
        wtot = [inc[w * lanes + lanes - 1] for w in range(nw)]
        for j in range(threads):
            w, ln = divmod(j, lanes)
            pre = carry
            for a in wtot[:w]:
                pre = _combine(pre, a)
            pre = _combine(pre, ID if ln == 0 else inc[j - 1])
            incl, f1, f2, p1, p2 = pre[0], pre[2], pre[3], pre[4], pre[5]
            for r, (s, p, l, o) in enumerate(tv[j]):
                t = t0s[j] + r
                if t >= M:
                    break
                if s:
                    q1 = (p << 16) | o
                    q2 = ((p + l - 1) << 16) | lits[j][r]
                    p1, p2 = max(p1, f1), max(p2, f2)
                    f1, f2 = max(f1, q1), max(f2, q2)
                    incl += int(_size(fmt, lits[j][r], l, o)[0])
                posN = min([sufs[j]] + [p2_ if s2 else BIG for (s2, p2_, _,
                                                               _), ok in
                                        zip(tv[j][r + 1:], real[j][r + 1:])
                                        if ok])
                res[:, t] = (incl, BIG if posN == IMAX else posN, f1, f2,
                             p1, p2)
        for a in wtot:
            carry = _combine(carry, a)
    return res


def model_keys(fmt, data, n, tiles, Bk, G):
    """Each byte's (op, value) from its tile's fields (op >= DUMMY: sorts
    last)."""
    incl, posN, f1, f2, p1, p2 = (np.repeat(x, G) for x in tiles)
    i = np.arange(Bk)
    hasF = f1 != 0
    posF, offF = f1 >> 16, f1 & 0xFFFF
    endF = np.where(hasF, (f2 >> 16) + 1, 0)
    litF = f2 & 0xFFFF
    posP, offP, endP1, litP = p1 >> 16, p1 & 0xFFFF, p2 >> 16, p2 & 0xFFFF
    covered = hasF & (i < endF)
    useP = i < posF - litF
    pos = np.where(useP, posP, posF)
    off = np.where(useP, offP, offF)
    lit = np.where(useP, litP, litF)
    end = np.where(useP, endP1 + 1, endF)
    ml = end - pos
    szF = _size(fmt, litF, endF - posF, offF)[0]
    sz, hdr_all = _size(fmt, lit, ml, off)
    excl = np.where(useP, incl - szF - sz, incl - sz)
    k = i - pos
    d = data.astype(np.int64)
    if fmt == "lz4":
        nl = _nlx(lit)
        opL = excl + 1 + nl + (i - (pos - lit))
        base = excl + 1 + nl + lit
        j = k - nl - 3
        op_sp = np.select([k == 0, k <= nl, k == nl + 1, k == nl + 2],
                          [excl, excl + k, base, base + 1], base + 2 + j)
        tok = (np.minimum(lit, 15) << 4) | np.minimum(ml - 4, 15)
        v_sp = np.select(
            [k == 0, k <= nl, k == nl + 1, k == nl + 2],
            [tok, np.clip(lit - 15 - 255 * (k - 1), 0, 255), off & 255,
             off >> 8], np.clip(ml - 19 - 255 * j, 0, 255))
        dead = k >= hdr_all
        opN = incl + 1 + _nlx(posN - endF) + (i - endF)
    else:
        h = _lit_hdr(lit)
        n64, l3, qual, ncopy, cb = _copy(ml, off)
        opL = excl + h + (i - (pos - lit))
        k2 = k - h
        lm1 = lit - 1
        tag = np.where(lit <= 60, lm1 << 2, np.where(lit <= 256, 240, 244))
        v_hdr = np.select([k == 0, k == 1], [tag, lm1 & 0xFF],
                          (lm1 >> 8) & 0xFF)
        k2c = np.clip(k2, 0, 1023)
        jop = (k2c * 43691) >> 17
        r = k2c - 3 * jop
        mid = np.where(jop < n64, 0xFE, 0xEE)
        relf = k2 - 3 * (ncopy - 1)
        fin = np.where(qual, 0x01 | ((l3 - 4) << 2) | ((off >> 8) << 5),
                       0x02 | ((l3 - 1) << 2))
        v_cp = np.where(
            k2 < 3 * (ncopy - 1),
            np.select([r == 0, r == 1], [mid, off & 0xFF], off >> 8),
            np.select([relf == 0, relf == 1], [fin, off & 0xFF], off >> 8))
        op_sp = np.where(k < h, excl + k, excl + h + lit + k2)
        v_sp = np.where(k < h, v_hdr, v_cp)
        dead = k2 >= cb
        opN = incl + _lit_hdr(posN - endF) + (i - endF)
    op = np.where(covered, np.where(k < 0, opL, np.where(dead, DUMMY,
                                                          op_sp)),
                  np.where(posN >= BIG, DUMMY, opN))
    val = np.where(covered & (k >= 0), v_sp, d)
    op = np.where(i < n, op, DUMMY)
    return op, val


def model_place(op, val, body, Bk):
    """The kernel's placement: the first key at each op in [0, cap) with a
    byte value in the bitmap, every other non-last key in the irregular
    list; ranks by the bitmap's prefix count, the list merged in."""
    cap = (Bk + Bk // 16 + 256 + 1023) & ~1023
    live = op < DUMMY
    key = ((op.astype(np.int64) << 8) | val) & 0xFFFFFFFF
    key = np.where(key >= 1 << 31, key - (1 << 32), key)
    occ = np.zeros(cap, bool)
    vals = np.zeros(cap, np.int64)
    xl = []
    for o, v, kk in zip(op[live], val[live], key[live]):
        if 0 <= o < cap and 0 <= v <= 255 and not occ[o]:
            occ[o], vals[o] = True, v
        else:
            xl.append(int(kk))
    xs = np.sort(np.array(xl, np.int64))
    pre = np.concatenate([[0], np.cumsum(occ)])
    nr, nx = int(occ.sum()), xs.size
    nd = Bk - nr - nx
    lim = max(0, min(int(body), Bk))
    out = np.zeros(Bk, np.uint8)
    for o in np.nonzero(occ)[0]:
        rank = pre[o] + np.searchsorted(xs, (o << 8) | vals[o], "left")
        if rank < lim:
            out[rank] = vals[o]
    for a, x in enumerate(xs):
        below = 0
        if x >= 0:
            o = x >> 8
            below = nr if o >= cap else pre[o] + int(
                occ[o] and vals[o] <= (x & 255))
        rank = below + a + (nd if x >= 1 << 26 else 0)
        if rank < lim:
            out[rank] = x & 0xFF
    return out, nx


def model(fmt, arr, lens, sel, cpos, cml, coff, Bk, G):
    """The kernels' design on a batch: (out, body, tail, flag, irregular
    keys a row)."""
    M = Bk // G
    outs, bodies, tails, flags, nxs = [], [], [], [], []
    for r in range(arr.shape[0]):
        tiles = model_tiles(fmt, sel[r], cpos[r], cml[r], coff[r], M)
        op, val = model_keys(fmt, arr[r], int(lens[r]), tiles, Bk, G)
        body = int(tiles[0, -1])
        o, nx = model_place(op, val, body, Bk)
        ends = np.where(sel[r], cpos[r].astype(np.int64) + cml[r], 0)
        pe = np.concatenate([[0], np.maximum.accumulate(ends)[:-1]])
        lit = cpos[r].astype(np.int64) - pe
        _, hdr = _size(fmt, lit, cml[r].astype(np.int64),
                       coff[r].astype(np.int64))
        outs.append(o), bodies.append(body), nxs.append(nx)
        tails.append(int(lens[r]) - int(ends.max()))
        flags.append(bool((sel[r] & (hdr > cml[r])).any()))
    return (np.stack(outs), np.array(bodies, np.int32),
            np.array(tails, np.int32), np.array(flags)), nxs


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("G", GRIDS)
def test_model_matches_plain(staged, fmt, G):
    """The kernels' design gives the plain version's outputs on the
    encoders' tile parse, with no irregular key."""
    args = staged[G]
    got, nxs = model(fmt, *args, B, G)
    _same(got, _plain(fmt, args, B, G), f"model {fmt} G={G}")
    assert nxs == [0] * len(nxs)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("G", (2, 8))
def test_model_irregular(fmt, G):
    """On tile parses no _grid_select gives (positions collide, holes,
    values past a byte), the design's irregular-key list still gives the
    sort's bytes."""
    Bk = 1024
    args = irregular(Bk, G, seed=G + len(fmt))
    got, nxs = model(fmt, *args, Bk, G)
    _same(got, _plain(fmt, args, Bk, G), f"irregular {fmt} G={G}")
    assert max(nxs) > 0 and max(nxs) <= 2048


# --- card only: the kernels against their plain versions --------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(Bk, N, G, seed, dev):
    """N rows of the kinds above (each seven from their own seed) and their
    tile parse (on dev), as numpy arrays."""
    made = [rows(Bk, seed + k) for k in range(-(-N // 7))]
    arr = np.concatenate([a for a, _ in made])[:N]
    lens = np.concatenate([n for _, n in made])[:N]
    return (arr, lens) + tuple(x.cpu().numpy() for x in
                               tile_parse(arr, lens, Bk, G, dev))


def _check_card(fmt, args, Bk, G, dev):
    want = _plain(fmt, args, Bk, G)
    got = DISPATCH[fmt](*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in args), Bk, G)
    torch.cuda.synchronize()
    _same([x.cpu().numpy() for x in got], want, f"card {fmt} G={G}")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("G", GRIDS)
@pytest.mark.parametrize("N", (1, 3, 64, 256))
def test_kernel_matches_plain(cuda_device, fmt, G, N):
    from aocl_compression_tpu_torch.ops import emit_sorted as es
    before = dict(es.launches)
    _check_card(fmt, _batch(B, N, G, N, cuda_device), B, G,
                cuda_device)
    assert es.launches[f"emit_{fmt}"] == before[f"emit_{fmt}"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("N", (1, 3))
def test_kernel_full_rows(cuda_device, fmt, N):
    """Rows of 65,536 at G = 4 (the main path's shape)."""
    _check_card(fmt, _batch(65536, N, 4, 20 + N, cuda_device), 65536,
                4, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("G", GRIDS)
def test_kernel_irregular(cuda_device, fmt, G):
    _check_card(fmt, irregular(1024, G, seed=G + len(fmt)), 1024, G,
                cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel_strided_parse(cuda_device, fmt):
    """The tile fields as _grid_select returns them on the card (strided
    views) go to the kernel as they are."""
    data, n = (torch.from_numpy(a).to(cuda_device)
               for a in rows(B, seed=3))
    mlen, moff, valid = tlz._find_matches(data, n, B, depth=4, nw=8)
    parse = tlz._grid_select(mlen, moff, valid, B, 4, match_cap=36)
    assert not all(x.is_contiguous() for x in parse)
    got = DISPATCH[fmt](data, n, *parse, B, 4)
    want = PLAIN[fmt](data.cpu(), n.cpu(), *(x.cpu() for x in parse), B, 4)
    torch.cuda.synchronize()
    _same([x.cpu().numpy() for x in got], [x.numpy() for x in want],
          f"strided {fmt}")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_card_path_runs_no_torch_op(cuda_device, fmt):
    """On CUDA tensors the dispatcher runs the kernel alone: no torch.sort,
    no other PyTorch op on the card (a dispatch mode sees every op)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    args = [torch.from_numpy(a).to(cuda_device)
            for a in _batch(B, 3, 4, 5, cuda_device)]
    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args_=(), kwargs=None):
            seen.append(str(func))
            return func(*args_, **(kwargs or {}))

    with Ops():
        got = DISPATCH[fmt](*args, B, 4)
    torch.cuda.synchronize()
    assert all("empty" in name for name in seen), seen
    want = PLAIN[fmt](*(a.cpu() for a in args), B, 4)
    _same([x.cpu().numpy() for x in got], [x.numpy() for x in want],
          f"no-op {fmt}")
