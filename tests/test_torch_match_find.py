"""The match finder (ops/match_find.py, csrc/match_find.cu) and its plain
version against the JAX package.

On the CPU the port's _find_matches runs its plain version
(_find_matches_plain: the stages _match_sorted_keys_plain,
_match_candidates_plain and _match_runs_plain); the same seeded numpy rows
go through the JAX _find_matches (vmapped on the CPU) at every setting an
encoder calls it with, and at nw_deep, hash_bits 16, a small max_off and
four small offsets. The rows hold what the kernels must not get wrong:
nonzero bytes past the block length n (they take part in the compares), an
all-equal row, a 4-byte hash collision between two candidates, runs at
offsets 1, 2 and 4 across the end-of-block clamps, a far repeat that feeds
the saturated-match ladder, matches at max_off and max_off + 1, and B = 256.
A numpy model of the kernels' rule, position by position (the depth
previous same-hash positions, nearest first; a byte compare of the row
padded with zeros; the runs; the ladder as a walk; the clamps), equals the
plain version on the same rows. Two numpy models of the kernels' designs
equal their plain stages: match_keys' stable counting passes by the hash's
8-bit digits (per-warp counts, one scan, each warp's tiles placed in order)
give the sorted keys at hash_bits 1, 15 and 16; match_candidates' warp
tiles (a halo of min(depth, 16) entries, each lane's window, candidate s
from lane l - s, the warp votes that end the walks) give the plain
version's best candidates at every setting, past the halo (depth 20) and
past the registers (nw 40). Tolerance: exact equality on every output.

The JAX package is imported inside a fixture, so the card-only tests (the
kernels against the plain version at N = 1, 31 and 257 and B = 256, 4,096
and 65,536; match_keys at every hash_bits; no torch.sort on the card) also
run where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_match_find.py
"""

import functools

import numpy as np
import pytest
import torch

from aocl_compression_tpu_torch.ops import lz4_device as tdev
from aocl_compression_tpu_torch.ops import match_find

B = 1024

# name -> _find_matches keyword arguments: every encoder's call, then the
# options no encoder of the API sets
SETTINGS = {
    "lz4 main path, snappy G=4 (depth 4, nw 8)": dict(depth=4, nw=8),
    "snappy G=0, defaults (depth 2, nw 16)": dict(),
    "lz4 bench config (depth 5, nw 5, ext_passes 5)":
        dict(depth=5, nw=5, ext_passes=5),
    "lz4hc 4 (depth 6, nw 16)": dict(depth=6, nw=16),
    "lz4hc 9 (depth 11, nw 32)": dict(depth=11, nw=32),
    "zlib 1-2 (max_off 32768)": dict(max_off=32768),
    "zstd 1 (depth 8)": dict(depth=8),
    "lzma assist (depth 16)": dict(depth=16),
    "nw_deep 2 (depth 5, nw 5)": dict(depth=5, nw=5, nw_deep=2),
    "hash_bits 16, nw_deep 8 (depth 4, nw 16)":
        dict(depth=4, nw=16, nw_deep=8, hash_bits=16),
    "max_off 40 (depth 2, nw 16)": dict(max_off=40),
    "offsets 1, 2, 4, 8 and ext_passes 3 (depth 3, nw 4)":
        dict(depth=3, nw=4, small_offsets=(1, 2, 4, 8), ext_passes=3),
}
# the settings also held at B = 256
SMALL_B = ("lz4 main path, snappy G=4 (depth 4, nw 8)",
           "lz4 bench config (depth 5, nw 5, ext_passes 5)",
           "max_off 40 (depth 2, nw 16)")
# match_candidates past its halo of 16 shuffled candidates and past its 32
# register words (no encoder sets these)
DEEP = {"depth 20 (past the halo)": dict(depth=20),
        "nw 40 (past the registers; depth 3)": dict(depth=3, nw=40)}
_WORDS = [b"the ", b"of ", b"compression ", b"data ", b"block ", b"match ",
          b"hash ", b"entropy ", b"stream ", b"window "]


def _hash(w, bits):
    return ((np.asarray(w, np.uint64) * 2654435761) & 0xFFFFFFFF) >> (
        32 - bits)


def _collision(rng):
    """Two different 4-byte words with one 16-bit (so also 15-bit) hash."""
    seen = {}
    while True:
        w = int(rng.integers(1, 1 << 32))
        h = int(_hash(w, 16))
        if h in seen and seen[h] != w:
            return (np.frombuffer(np.uint32(seen[h]).tobytes(), np.uint8),
                    np.frombuffer(np.uint32(w).tobytes(), np.uint8))
        seen[h] = w


def _text(n, rng):
    out = b"".join(_WORDS[i] for i in rng.integers(0, len(_WORDS), n // 2))
    return np.frombuffer(out[:n], np.uint8).copy()


def _row(kind, Bk, rng):
    """One seeded row (Bk bytes) and its block length n."""
    if kind == "text, junk past n":
        a = rng.integers(1, 256, Bk).astype(np.uint8)
        n = Bk * 11 // 16
        a[:n] = _text(n, rng)
        return a, n
    if kind == "all equal":
        return np.full(Bk, ord("a"), np.uint8), Bk
    if kind == "hash collision":
        w1, w2 = _collision(rng)
        suffix = rng.integers(0, 256, 12).astype(np.uint8)
        a = _text(Bk, rng)
        i = 3
        while i + 32 <= Bk:   # w1 S, w2 S, w1 S, ...: the nearest candidate
            a[i:i + 4] = w1 if (i // 32) % 2 == 0 else w2  # collides
            a[i + 4:i + 16] = suffix
            i += 32
        return a, Bk
    if kind == "runs across the clamps":
        a = rng.integers(1, 256, Bk).astype(np.uint8)
        n = Bk - 37
        a[:n - 120] = _text(n - 120, rng)
        a[n - 110:n - 70] = np.tile(np.frombuffer(b"wxyz", np.uint8), 10)
        a[n - 60:n - 2] = np.tile(np.frombuffer(b"ab", np.uint8), 29)
        a[n - 30:n + 10] = ord("z")
        return a, n
    if kind == "far repeat":
        seg = rng.integers(0, 256, min(400, Bk // 3)).astype(np.uint8)
        a = np.concatenate([seg, _text(Bk // 8, rng), seg, seg,
                            _text(Bk, rng)])[:Bk]
        return a, Bk
    if kind == "max_off edges":
        a = rng.integers(0, 256, Bk).astype(np.uint8)
        pat = np.frombuffer(b"QWERTYUIOP", np.uint8)
        for p0, dist in ((20, 40), (90, 41), (160, 39)):
            p0 = p0 * Bk // 256
            a[p0:p0 + 10] = pat
            a[p0 + dist:p0 + dist + 10] = pat
            pat = pat[::-1].copy()
        return a, Bk
    if kind == "random":
        return rng.integers(0, 256, Bk).astype(np.uint8), Bk - 3
    raise ValueError(kind)


KINDS = ("text, junk past n", "all equal", "hash collision",
         "runs across the clamps", "far repeat", "max_off edges")


def _batch(Bk, seed, N=None):
    rng = np.random.default_rng(seed)
    kinds = KINDS if N is None else [
        (KINDS + ("random",))[i % (len(KINDS) + 1)] for i in range(N)]
    rows = [_row(k, Bk, rng) for k in kinds]
    return (np.stack([r for r, _ in rows]),
            np.array([n for _, n in rows], np.int32))


def _model(a, n, Bk, max_off=0, depth=2, nw=tdev.NW,
           small_offsets=tdev.SMALL_OFFSETS, hash_bits=tdev.HASH_BITS,
           nw_deep=0, ext_passes=0):
    """The kernels' rule for one row, position by position."""
    pad = np.concatenate([a, np.zeros(4 * nw + 8, np.uint8)]).astype(
        np.int64)
    w0 = pad[:Bk] | pad[1:Bk + 1] << 8 | pad[2:Bk + 2] << 16 \
        | pad[3:Bk + 3] << 24
    h = _hash(w0, hash_bits)
    bucket = {}
    blen = np.zeros(Bk, np.int64)
    boff = np.ones(Bk, np.int64)
    for p in range(Bk):
        prev = bucket.setdefault(int(h[p]), [])
        for s, q in enumerate(prev[::-1][:depth], 1):
            off = p - q
            if (max_off and off > max_off) or w0[q] != w0[p]:
                continue
            nws = nw if s == 1 or not nw_deep else min(nw, nw_deep)
            cap = 4 + 4 * nws
            eq = pad[q:q + cap] == pad[p:p + cap]
            ml = cap if eq.all() else int(np.argmin(eq))
            if ml > blen[p]:
                blen[p], boff[p] = ml, off
        prev.append(p)
    for o in small_offsets:
        run = np.zeros(Bk + 1, np.int64)
        for i in range(Bk - 1, -1, -1):
            run[i] = run[i + 1] + 1 if i >= o and a[i] == a[i - o] else 0
        better = (run[:Bk] >= 4) & (run[:Bk] > blen)
        blen = np.where(better, run[:Bk], blen)
        boff = np.where(better, o, boff)
    if ext_passes:
        capv = 4 + 4 * nw
        out = blen.copy()
        for i in range(Bk):
            j, m = i, 0
            while (m < 2 ** ext_passes - 1 and j + capv < Bk
                   and blen[j] >= capv and boff[j + capv] == boff[j]):
                j, m = j + capv, m + 1
            out[i] = (j - i) + blen[j]
        blen = out
    idx = np.arange(Bk)
    blen = np.minimum(blen, n - 5 - idx)
    valid = (blen >= 4) & (idx <= n - 13) & (idx < n)
    return np.where(valid, blen, 1), np.maximum(boff, 1), valid


KEY_WARPS = 32    # match_keys' warps a CTA (csrc/match_find.cu kKeyWarps)
MAX_HALO = 16     # match_candidates' kMaxHalo


def _counting_pass(digit, value, Bk, ctas):
    """match_keys' counting pass over a row shared by a cluster of `ctas`
    CTAs (CTA c the elements [c*E, (c+1)*E), E whole tiles): each warp's
    run of 32-element tiles is counted by digit; a digit's first slot in a
    warp is the count of the smaller digits in the row, of the digit in the
    CTAs and warps before it; each warp places its tiles in order, a lane
    at its digit's next slot plus its rank among the earlier lanes of its
    tile with that digit."""
    ntiles = -(-Bk // 32)
    E = -(-ntiles // ctas) * 32
    e = np.arange(Bk)
    c = e // E
    per = -(-(-(-np.minimum(E, Bk - c * E) // 32)) // KEY_WARPS)
    group = c * KEY_WARPS + (e - c * E) // 32 // per
    hist = np.zeros((256, ctas * KEY_WARPS), np.int64)
    np.add.at(hist, (digit, group), 1)
    nxt = (np.cumsum(hist) - hist.ravel()).reshape(hist.shape)
    out = np.empty(Bk, np.int64)
    for t in range(ntiles):
        et = np.arange(t * 32, min(Bk, t * 32 + 32))
        d, g = digit[et], group[et]
        rank = np.tril(d[:, None] == d[None, :], -1).sum(axis=1)
        out[nxt[d, g] + rank] = value[et]
        np.add.at(nxt, (d, g), 1)
    return out


def _keys_model(a, Bk, hash_bits, ctas):
    """The kernel match_keys on one row: LSD counting passes by the 8-bit
    digits of the bucket (the hash, its top bit flipped at 16 bits so the
    buckets come in int32-key order), then the keys in slot order."""
    pad = np.concatenate([a, np.zeros(8, np.uint8)]).astype(np.int64)
    w0 = pad[:Bk] | pad[1:Bk + 1] << 8 | pad[2:Bk + 2] << 16 \
        | pad[3:Bk + 3] << 24
    flip = 0x8000 if hash_bits == 16 else 0
    bucket = _hash(w0, hash_bits).astype(np.int64) ^ flip
    pos = np.arange(Bk)
    if hash_bits > 8:
        pos = _counting_pass(bucket & 255, pos, Bk, ctas)
        digit = bucket[pos] >> 8
    else:
        digit = bucket
    keys = ((bucket[pos] ^ flip) << 16) | pos
    return _counting_pass(digit, keys, Bk, ctas).astype(np.uint32).view(
        np.int32)


def _low_equal_bytes(x):
    return ((x & 0xFF) == 0).astype(np.int64) + ((x & 0xFFFF) == 0) \
        + ((x & 0xFFFFFF) == 0)


def _candidates_model(a, skey, Bk, max_off, depth, nw, nw_deep, slices):
    """The kernel match_candidates on one row cut into `slices`: a warp
    tile's lanes hold min(depth, 16) halo entries, then new sorted entries;
    candidate s of lane l is lane l - s (__shfl_up_sync leaves lanes below
    s their own value); the walk over s ends when no lane still shares its
    hash, a compare (voted every 4 words) when no lane is still equal, and
    a lane keeps the first word that differs; candidates past the halo are
    walked by each lane alone. Returns (offset << 16 | length) by
    position as uint32."""
    pad = np.concatenate([a, np.zeros(4 * nw + 8, np.uint8)]).astype(
        np.uint32)

    def word(x):
        return pad[x] | pad[x + 1] << 8 | pad[x + 2] << 16 | pad[x + 3] << 24

    skey = skey.astype(np.int64) & 0xFFFFFFFF
    nw_far = min(nw, nw_deep) if nw_deep else nw
    halo = min(depth, MAX_HALO)
    lanes = np.arange(32)
    out = np.zeros(Bk, np.uint32)
    size = -(-Bk // slices)
    for j0 in range(0, Bk, size):
        j1 = min(Bk, j0 + size)
        for t0 in range(j0, j1, 32 - halo):
            j = t0 - halo + lanes
            have = (j >= 0) & (j < Bk)
            k = np.where(have, skey[np.clip(j, 0, Bk - 1)], 0)
            h = np.where(have, k >> 16, -1)
            p = k & 0xFFFF
            win = [word(p + 4 * i) for i in range(nw + 1)]
            mine = (lanes >= halo) & (j < j1)
            alive = mine.copy()
            blen = np.zeros(32, np.int64)
            boff = np.ones(32, np.int64)
            for s in range(1, halo + 1):
                src = np.where(lanes >= s, lanes - s, lanes)
                alive &= h[src] == h
                if not alive.any():
                    break
                off = p - p[src]
                ok = alive & (win[0][src] == win[0])
                if max_off:
                    ok &= off <= max_off
                nws = nw if s == 1 else nw_far
                live = ok.copy()
                at = np.zeros(32, np.int64)
                xm = np.zeros(32, np.uint32)
                for i in range(1, nws + 1):
                    if i % 4 == 1 and not live.any():
                        break
                    x = win[i] ^ win[i][src]
                    miss = live & (x != 0)
                    at, xm = np.where(miss, i, at), np.where(miss, x, xm)
                    live &= x == 0
                ln = np.where(at > 0, 4 * at + _low_equal_bytes(xm),
                              4 + 4 * nws)
                better = ok & (ln > blen)
                blen = np.where(better, ln, blen)
                boff = np.where(better, off, boff)
            for ln_ in np.flatnonzero(alive):
                for s in range(halo + 1, depth + 1):
                    if j[ln_] - s < 0 or skey[j[ln_] - s] >> 16 != h[ln_]:
                        break
                    q, pp = int(skey[j[ln_] - s] & 0xFFFF), int(p[ln_])
                    if (max_off and pp - q > max_off) or \
                            word(q) != win[0][ln_]:
                        continue
                    cap = 4 + 4 * nw_far
                    eq = pad[q:q + cap] == pad[pp:pp + cap]
                    ml = cap if eq.all() else int(np.argmin(eq))
                    if ml > blen[ln_]:
                        blen[ln_], boff[ln_] = ml, pp - q
            out[p[mine]] = ((boff << 16) | blen)[mine]
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(port, ref):
    for p, r in zip(port, ref):
        if isinstance(r, torch.Tensor):
            r = r.cpu().numpy()
        np.testing.assert_array_equal(p.cpu().numpy(), np.asarray(r))


@pytest.fixture(scope="module")
def jax_mods():
    import jax
    import jax.numpy as jnp
    from aocl_compression_tpu.ops import lz4_device as jdev
    return jax, jnp, jdev


def _jax_find(jax_mods, arr, lens, Bk, kw):
    """JAX's _find_matches, vmapped: jitted where its graph compiles in a
    few seconds, op by op where the compile takes longer (deep chains)."""
    jax, jnp, jdev = jax_mods
    fn = jax.vmap(functools.partial(jdev._find_matches, B=Bk, **kw))
    if kw.get("depth", 2) * kw.get("nw", tdev.NW) >= 100:
        with jax.disable_jit():
            res = fn(jnp.asarray(arr), jnp.asarray(lens))
    else:
        res = jax.jit(fn)(jnp.asarray(arr), jnp.asarray(lens))
    return [np.asarray(x) for x in res]


CASES = [(name, B) for name in SETTINGS] + [(name, 256) for name in SMALL_B]


@pytest.mark.parametrize("name,Bk", CASES)
def test_plain_matches_jax(jax_mods, name, Bk):
    arr, lens = _batch(Bk, seed=Bk + 1)
    kw = SETTINGS[name]
    _eq(tdev._find_matches_plain(_t(arr), _t(lens), Bk, **kw),
        _jax_find(jax_mods, arr, lens, Bk, kw))


@pytest.mark.parametrize("name,Bk", CASES)
def test_model_matches_plain(name, Bk):
    arr, lens = _batch(Bk, seed=Bk + 1)
    kw = SETTINGS[name]
    got = tdev._find_matches_plain(_t(arr), _t(lens), Bk, **kw)
    for i in range(arr.shape[0]):
        _eq([g[i] for g in got], _model(arr[i], int(lens[i]), Bk, **kw))


@pytest.mark.parametrize("hash_bits", [1, 15, 16])
@pytest.mark.parametrize("Bk", [256, 1000, 4096])
def test_keys_model_matches_sorted_keys(hash_bits, Bk):
    """match_keys' counting passes, with a row on 1, 2 or 8 CTAs, give
    torch.sort of the plain keys: the buckets in int32-key order (at 16
    bits the hashes >= 32,768 first), positions ascending in each, on the
    seeded rows (the all-equal row is one bucket, the collision row two
    words in one bucket)."""
    arr, _ = _batch(Bk, seed=Bk + hash_bits)
    want = tdev._match_sorted_keys_plain(_t(arr), Bk, hash_bits)
    np.testing.assert_array_equal(
        want.numpy(), torch.sort(tdev._match_keys_plain(
            _t(arr), Bk, hash_bits), dim=-1).values.numpy())
    for i in range(arr.shape[0]):
        for ctas in (1, 2, 8):
            np.testing.assert_array_equal(
                _keys_model(arr[i], Bk, hash_bits, ctas), want[i].numpy())
    if hash_bits == 16:    # the wrap does put keys below 0 first
        assert (want < 0).any() and (want >= 0).any()


CAND_CASES = CASES + [(name, B) for name in DEEP]


@pytest.mark.parametrize("name,Bk", CAND_CASES)
def test_candidates_model_matches_plain(name, Bk):
    """match_candidates' warp tiles (halo, lane windows, shuffled
    candidates, the early votes; the row cut into two slices as the
    launcher cuts B = 1,024 for one row) give the plain version's best
    candidates at every setting."""
    arr, _ = _batch(Bk, seed=Bk + 1)
    kw = dict(SETTINGS, **DEEP)[name]
    hb = kw.get("hash_bits", tdev.HASH_BITS)
    args = (kw.get("max_off", 0), kw.get("depth", 2), kw.get("nw", tdev.NW),
            kw.get("nw_deep", 0))
    skey = tdev._match_sorted_keys_plain(_t(arr), Bk, hb)
    want = tdev._match_candidates_plain(_t(arr), skey, Bk, *args)
    for i in range(arr.shape[0]):
        np.testing.assert_array_equal(
            _candidates_model(arr[i], skey[i].numpy(), Bk, *args, slices=2),
            want[i].numpy().view(np.uint32))


def test_rows_hold_the_edges():
    """The rows do hold what they are meant to: a collision the nearest
    candidate loses to a deeper one, matches at offsets 40 and 41, runs at
    offsets 1, 2 and 4 across the clamps, the ladder past the cap."""
    arr, lens = _batch(B, seed=B + 1)
    kw = SETTINGS["max_off 40 (depth 2, nw 16)"]
    _, moff, valid = tdev._find_matches_plain(_t(arr), _t(lens), B, **kw)
    _, moff_all, _ = tdev._find_matches_plain(_t(arr), _t(lens), B)
    edge = KINDS.index("max_off edges")
    assert 40 in moff[edge][valid[edge]].tolist()
    assert 41 not in moff[edge][valid[edge]].tolist()
    assert 41 in moff_all[edge].tolist()
    coll = KINDS.index("hash collision")
    assert 64 in moff_all[coll].tolist()    # past the colliding s = 1
    runs = KINDS.index("runs across the clamps")
    mlen, moff, valid = tdev._find_matches_plain(_t(arr), _t(lens), B)
    assert {1, 2, 4} <= set(moff[runs][valid[runs]].tolist())
    kw = SETTINGS["lz4 bench config (depth 5, nw 5, ext_passes 5)"]
    mlen, _, valid = tdev._find_matches_plain(_t(arr), _t(lens), B, **kw)
    far = KINDS.index("far repeat")
    assert int(mlen[far][valid[far]].max()) > 4 + 4 * 5


def test_dispatch_and_wrappers_refuse_other_devices():
    arr, lens = _batch(256, seed=3)
    data, n = _t(arr), _t(lens)
    _eq(tdev._find_matches(data, n, 256, depth=4, nw=8),
        tdev._find_matches_plain(data, n, 256, depth=4, nw=8))
    with pytest.raises(ValueError):
        tdev._find_matches(data.to("meta"), n.to("meta"), 256)
    key = tdev._match_keys_plain(data, 256, 15)
    with pytest.raises(ValueError):
        match_find.match_keys(data, 256, 15)
    with pytest.raises(ValueError):
        match_find.match_candidates(data, key, 256, 0, 4, 8, 0)
    with pytest.raises(ValueError):
        match_find.match_runs(data, key, n, 256, (1, 2, 4), 8, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 31, 257])
@pytest.mark.parametrize("Bk", [256, 4096, 65536])
def test_kernels_match_plain(cuda_device, N, Bk):
    """Every stage and every output of the kernel path equal to the plain
    version on the card, at every setting, on seeded rows of every kind
    (and random ones): match_keys gives the plain sorted keys, and each of
    match_keys and match_candidates launches twice a setting (alone and in
    _find_matches), match_runs once."""
    arr, lens = _batch(Bk, seed=N * Bk, N=N)
    data, n = _t(arr).to(cuda_device), _t(lens).to(cuda_device)
    before = dict(match_find.launches)
    for name, kw in SETTINGS.items():
        hb = kw.get("hash_bits", tdev.HASH_BITS)
        skey = match_find.match_keys(data, Bk, hb)
        _eq([skey], [tdev._match_sorted_keys_plain(data, Bk, hb)])
        args = (Bk, kw.get("max_off", 0), kw.get("depth", 2),
                kw.get("nw", tdev.NW), kw.get("nw_deep", 0))
        _eq([match_find.match_candidates(data, skey, *args)],
            [tdev._match_candidates_plain(data, skey, *args)])
        got = tdev._find_matches(data, n, Bk, **kw)
        torch.cuda.synchronize()
        _eq(got, tdev._find_matches_plain(data, n, Bk, **kw))
    for k in before:
        assert match_find.launches[k] - before[k] == 2 * len(SETTINGS) - (
            k == "match_runs") * len(SETTINGS)


@pytest.mark.cuda
def test_kernels_take_unaligned_rows(cuda_device):
    """A batch that starts off a 16-byte boundary, and B not a multiple of
    16 (the wrapper takes any B up to 65,536)."""
    arr, lens = _batch(1000, seed=8, N=7)
    flat = torch.zeros(7 * 1000 + 3, dtype=torch.uint8)
    flat[3:] = _t(arr).reshape(-1)
    data = flat.to(cuda_device)[3:].view(7, 1000)
    n = _t(lens).to(cuda_device)
    for kw in (dict(depth=4, nw=8), dict(depth=5, nw=5, ext_passes=5)):
        got = tdev._find_matches(data, n, 1000, **kw)
        torch.cuda.synchronize()
        _eq(got, tdev._find_matches_plain(data, n, 1000, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("hash_bits", [1, 7, 8, 9, 12, 15, 16])
@pytest.mark.parametrize("N,Bk", [(1, 65536), (5, 1000), (3, 4096)])
def test_match_keys_every_hash_bits(cuda_device, hash_bits, N, Bk):
    """match_keys equal to the plain sorted keys at one counting pass
    (hash_bits <= 8) and two, on seeded rows of every kind."""
    arr, _ = _batch(Bk, seed=hash_bits * Bk + N, N=N)
    data = _t(arr).to(cuda_device)
    _eq([match_find.match_keys(data, Bk, hash_bits)],
        [tdev._match_sorted_keys_plain(data, Bk, hash_bits)])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DEEP))
@pytest.mark.parametrize("N,Bk", [(1, 65536), (9, 4096)])
def test_candidates_past_halo_and_registers(cuda_device, name, N, Bk):
    """match_candidates and the kernel path equal to the plain version
    where the walk goes past the 16 shuffled candidates or past the 32
    register words."""
    arr, lens = _batch(Bk, seed=N + Bk, N=N)
    data, n = _t(arr).to(cuda_device), _t(lens).to(cuda_device)
    kw = DEEP[name]
    skey = match_find.match_keys(data, Bk, tdev.HASH_BITS)
    args = (Bk, kw.get("max_off", 0), kw.get("depth", 2),
            kw.get("nw", tdev.NW), kw.get("nw_deep", 0))
    _eq([match_find.match_candidates(data, skey, *args)],
        [tdev._match_candidates_plain(data, skey, *args)])
    _eq(tdev._find_matches(data, n, Bk, **kw),
        tdev._find_matches_plain(data, n, Bk, **kw))


@pytest.mark.cuda
def test_find_matches_calls_no_sort(cuda_device, monkeypatch):
    """On a CUDA tensor _find_matches runs the kernels alone: with
    torch.sort made to raise it still gives the plain version's outputs."""
    arr, lens = _batch(4096, seed=5, N=7)
    data, n = _t(arr).to(cuda_device), _t(lens).to(cuda_device)
    want = {name: tdev._find_matches_plain(data, n, 4096, **kw)
            for name, kw in SETTINGS.items()}

    def no_sort(*args, **kw):
        raise AssertionError("torch.sort called on the card path")

    monkeypatch.setattr(torch, "sort", no_sort)
    got = {name: tdev._find_matches(data, n, 4096, **kw)
           for name, kw in SETTINGS.items()}
    torch.cuda.synchronize()
    monkeypatch.undo()
    for name in SETTINGS:
        _eq(got[name], want[name])
