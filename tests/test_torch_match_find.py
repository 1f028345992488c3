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

A numpy model of match_runs' design (a row over a cluster of 1, 2, 8 or
16 CTAs, the first disagreements and their suffix minimum across CTAs and
warps, the 32-bit packing, the doubled link bitmaps and the descent)
equals _match_runs_plain at every setting and on chip_smoke.runs_rows
(ladder chains of 2^P - 1 and 2^P links ending at slice boundaries and at
B - 1); the descent equals the walk for P = 1..6.

The JAX package is imported inside a fixture, so the card-only tests (the
kernels against the plain version at N = 1, 2, 3, 5, 9, 31, 64 and 257
and B = 256, 4,096 and 65,536; match_runs on the seeded boundary rows;
match_keys at every hash_bits; no torch.sort on the card) also run where
JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_match_find.py
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from aocl_compression_tpu_torch.ops import lz4_device as tdev
from aocl_compression_tpu_torch.ops import match_find

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
SMOKE = importlib.util.module_from_spec(_spec)    # its match_runs rows
_spec.loader.exec_module(SMOKE)

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


def _walk(blen, boff, Bk, capv, ext_passes):
    """The ladder as a walk: from each position, at most 2^ext_passes - 1
    links of stride capv (saturated here, the same offset capv on)."""
    out = blen.copy()
    for i in range(Bk):
        j, m = i, 0
        while (m < 2 ** ext_passes - 1 and j + capv < Bk
               and blen[j] >= capv and boff[j + capv] == boff[j]):
            j, m = j + capv, m + 1
        out[i] = (j - i) + blen[j]
    return out


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
        blen = _walk(blen, boff, Bk, 4 + 4 * nw, ext_passes)
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


RUN_WARPS = 32    # match_runs' most warps a CTA (kMaxRunThreads / 32)


def _slices(Bk, ctas):
    """match_runs' cut of a row over a cluster of `ctas` CTAs: E positions
    a CTA (whole tiles) and its warps (a warp a tile at least)."""
    E = -(-(-(-Bk // 32)) // ctas) * 32
    return E, min(RUN_WARPS, E // 32)


def _runs_model(a, blen, boff, Bk, offsets, ctas):
    """match_runs' runs on one row over `ctas` CTAs. Per offset: each
    warp's first disagreement in its run of tiles, each CTA's, the minimum
    of the CTAs after a CTA and of the warps after a warp (the carry), then
    each warp's walk back over its tiles, a lane's next disagreement the
    first at or after it in its tile's mask, else the carry; a run of at
    least 4 longer than the candidate replaces it. Returns (blen, boff),
    each run checked to fit the 16-bit length of the packed word."""
    E, nwarps = _slices(Bk, ctas)
    tiles = -(-Bk // 32)
    idx = np.arange(tiles * 32)
    lanes = np.arange(32)
    blen, boff = blen.copy(), boff.copy()
    warps = []    # (CTA, first tile, end tile) of each warp, in order
    for c in range(ctas):
        e1 = min(Bk, c * E + E)
        e0 = min(c * E, e1)
        nt = -(-(e1 - e0) // 32)
        per = -(-nt // nwarps)
        for w in range(nwarps):
            t0 = min(nt, w * per)
            warps.append((c, e0 // 32 + t0, e0 // 32 + min(nt, t0 + per)))
    for o in offsets:
        ai = a[np.minimum(idx, Bk - 1)]
        ao = a[np.clip(idx - o, 0, Bk - 1)]
        mask = ((idx < Bk) & ((idx < o) | (ai != ao))).reshape(tiles, 32)
        first = np.array([t0 * 32 + np.flatnonzero(mask[t0:t1])[0]
                          if mask[t0:t1].any() else Bk
                          for _, t0, t1 in warps]).reshape(ctas, nwarps)
        cta_first = first.min(axis=1)
        nxt = np.empty(tiles * 32, np.int64)
        for k, (c, t0, t1) in enumerate(warps):
            w = k % nwarps
            carry = min(cta_first[c + 1:].min(initial=Bk),
                        first[c, w + 1:].min(initial=Bk))
            for t in range(t1 - 1, t0 - 1, -1):
                at = np.where(mask[t], lanes, 32)
                at = np.minimum.accumulate(at[::-1])[::-1]
                nxt[t * 32:t * 32 + 32] = np.where(at < 32, t * 32 + at,
                                                   carry)
                if mask[t].any():
                    carry = t * 32 + int(np.argmax(mask[t]))
        run = nxt[:Bk] - np.arange(Bk)
        assert run[0] == 0 and run.max() <= 0xFFFF
        better = (run >= 4) & (run > blen)
        blen = np.where(better, run, blen)
        boff = np.where(better, o, boff)
    return blen, boff


def _ladder_model(blen, boff, Bk, capv, ext_passes, ctas):
    """match_runs' ladder on one row: each position's (off << 16 | len) as
    one 32-bit word, the link bitmap in 32-bit words over the cluster's
    slices (link_0[i]: i + capv < Bk, len[i] >= capv, off[i + capv] ==
    off[i]), P doubled bitmaps, link_{p+1} = link_p & (link_p shifted by
    capv * 2^p, two words and a funnel shift), and the descent from p = P -
    1 to 0. Returns (len, off)."""
    assert boff.min() >= 1 and boff.max() <= 0xFFFF and blen.max() <= 0xFFFF
    word = (boff.astype(np.uint32) << 16) | blen.astype(np.uint32)
    plen, poff = (word & 0xFFFF).astype(np.int64), word >> 16
    levels = 0
    while levels < ext_passes and capv << levels < Bk:
        levels += 1
    E, _ = _slices(Bk, ctas)
    nwords = ctas * E // 32
    i = np.arange(Bk - capv) if capv < Bk else np.arange(0)
    link = np.zeros(nwords * 32, np.uint64)
    link[i] = (plen[i] >= capv) & (poff[i + capv] == poff[i])
    bits = [(link.reshape(nwords, 32) << np.arange(32, dtype=np.uint64)).sum(
        axis=1)]
    for p in range(1, levels):
        s = capv << (p - 1)
        prev = np.concatenate([bits[-1], np.zeros(s // 32 + 2, np.uint64)])
        g = np.arange(nwords) + s // 32
        shifted = ((prev[g + 1] << np.uint64(32) | prev[g])
                   >> np.uint64(s % 32)) & np.uint64(0xFFFFFFFF)
        bits.append(bits[-1] & shifted)
    j = np.arange(Bk)
    for p in range(levels - 1, -1, -1):
        hit = (bits[p][j >> 5] >> (j & 31).astype(np.uint64)) & np.uint64(1)
        j = j + np.where(hit == 1, capv << p, 0)
    return (j - np.arange(Bk)) + plen[j], poff.astype(np.int64)


def _runs_kernel_model(a, best, n, Bk, small_offsets, nw, ext_passes, ctas):
    """The kernel match_runs on one row: runs, ladder, end-of-block rules."""
    best = best.astype(np.int64) & 0xFFFFFFFF
    blen, boff = _runs_model(a, best & 0xFFFF, best >> 16, Bk,
                             small_offsets, ctas)
    if ext_passes:
        blen, boff = _ladder_model(blen, boff, Bk, 4 + 4 * nw, ext_passes,
                                   ctas)
    idx = np.arange(Bk)
    blen = np.minimum(blen, n - 5 - idx)
    valid = (blen >= 4) & (idx <= n - 13) & (idx < n)
    return np.where(valid, blen, 1), np.maximum(boff, 1), valid


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


@pytest.mark.parametrize("name,Bk", CASES)
def test_runs_model_matches_plain(name, Bk):
    """match_runs' design (the row over 1, 2 or 16 CTAs, the suffix minimum
    across CTAs and warps, the 32-bit packing, the doubled bitmaps and the
    descent) gives _match_runs_plain's outputs at every setting on the
    plain version's own best candidates."""
    arr, lens = _batch(Bk, seed=Bk + 1)
    kw = dict(max_off=0, depth=2, nw=tdev.NW, nw_deep=0,
              hash_bits=tdev.HASH_BITS, small_offsets=tdev.SMALL_OFFSETS,
              ext_passes=0)
    kw.update(SETTINGS[name])
    skey = tdev._match_sorted_keys_plain(_t(arr), Bk, kw["hash_bits"])
    best = tdev._match_candidates_plain(_t(arr), skey, Bk, kw["max_off"],
                                        kw["depth"], kw["nw"], kw["nw_deep"])
    runs = (kw["small_offsets"], kw["nw"], kw["ext_passes"])
    want = tdev._match_runs_plain(_t(arr), best, _t(lens), Bk, *runs)
    for i in range(arr.shape[0]):
        for ctas in (1, 2, 16):
            _eq([w[i] for w in want], _runs_kernel_model(
                arr[i], best[i].numpy(), int(lens[i]), Bk, *runs, ctas))


@pytest.mark.parametrize("setting", list(SMOKE.RUNS_SETTINGS))
@pytest.mark.parametrize("Bk", [256, 1000, 4096])
def test_runs_model_on_boundary_rows(setting, Bk):
    """The same on chip_smoke.runs_rows: an all-equal row, a repeat longer
    than half the row, ladder chains of 2^P - 1 and 2^P links ending at the
    slice boundaries of 2, 4, 8 and 16 CTAs and at B - 1, and runs across
    them; at B = 1,000 the last CTA's slice is short or empty."""
    offs, nw, ext = SMOKE.RUNS_SETTINGS[setting]
    data, best, n = SMOKE.runs_rows(4, Bk, nw, ext, seed=Bk + ext)
    want = tdev._match_runs_plain(data, best, n, Bk, offs, nw, ext)
    reach = 2 ** SMOKE.ladder_levels(Bk, nw, ext) * (4 + 4 * nw)
    if ext and reach < Bk // 2:    # a chain of 2^P links meets the cap
        assert (want[0][2] == reach).any()
    for i in range(4):
        for ctas in (1, 2, 8, 16):
            _eq([w[i] for w in want], _runs_kernel_model(
                data[i].numpy(), best[i].numpy(), int(n[i]), Bk, offs, nw,
                ext, ctas))


@pytest.mark.parametrize("levels", range(1, 7))
@pytest.mark.parametrize("capv", [8, 24, 100, 300])
def test_descent_equals_walk(levels, capv):
    """The descent over the doubled bitmaps takes min(links, 2^P - 1)
    links, as the walk does, on random saturated chains (runs of equal
    offsets), chains ending at B and a stride at or past B."""
    Bk = 1000
    rng = np.random.default_rng(levels * capv)
    blen = np.where(rng.random(Bk) < 0.8, capv + rng.integers(0, 3, Bk),
                    rng.integers(0, capv, Bk))
    boff = 1 + np.repeat(rng.integers(0, 3, Bk // 50 + 1), 50)[:Bk]
    blen[-capv - 1:] = capv    # chains that end only at B
    boff[-3 * capv:] = 7
    for ext in (levels, levels + 3):
        for ctas in (1, 8):
            got, off = _ladder_model(blen, boff, Bk, capv, ext, ctas)
            np.testing.assert_array_equal(
                got, _walk(blen, boff, Bk, capv, ext))
            np.testing.assert_array_equal(off, boff)
    big = _ladder_model(blen, boff, Bk, Bk, levels, 2)[0]    # CAPV >= B
    np.testing.assert_array_equal(big, blen)


def test_packing_fits_at_full_block():
    """At B = 65,536 a run fits the packed word's 16 bits: the all-equal
    row's run at offset 1 from position 1 is 65,535, at 0 it is 0."""
    Bk = 65536
    a = np.full(Bk, 7, np.uint8)
    blen, boff = _runs_model(a, np.zeros(Bk, np.int64), np.ones(Bk, np.int64),
                             Bk, (1,), 1)
    assert blen[0] == 0 and blen[1] == 0xFFFF and boff[1] == 1


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
@pytest.mark.parametrize("N", [1, 2, 3, 5, 9, 31, 64, 257])
@pytest.mark.parametrize("Bk", [256, 4096, 65536])
def test_kernels_match_plain(cuda_device, N, Bk):
    """Every stage and every output of the kernel path equal to the plain
    version on the card, at every setting, on seeded rows of every kind
    (and random ones), at the N where match_runs' CTAs a row change (16
    up to 8 rows, 8 at 9, 4 at 31, 2 at 64, 1 at 257; 2 with the ladder
    at 65,536):
    match_keys gives the plain sorted keys, and each of
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
@pytest.mark.parametrize("N", [2, 3, 5, 7, 9, 64])
def test_kernels_take_unaligned_rows(cuda_device, N):
    """A batch that starts off a 16-byte boundary, and B not a multiple of
    16 (the wrapper takes any B up to 65,536), over 16, 8 and 2 CTAs a
    row in match_runs."""
    arr, lens = _batch(1000, seed=8, N=N)
    flat = torch.zeros(N * 1000 + 3, dtype=torch.uint8)
    flat[3:] = _t(arr).reshape(-1)
    data = flat.to(cuda_device)[3:].view(N, 1000)
    n = _t(lens).to(cuda_device)
    for kw in (dict(depth=4, nw=8), dict(depth=5, nw=5, ext_passes=5)):
        got = tdev._find_matches(data, n, 1000, **kw)
        torch.cuda.synchronize()
        _eq(got, tdev._find_matches_plain(data, n, 1000, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("setting", list(SMOKE.RUNS_SETTINGS))
@pytest.mark.parametrize("N,Bk", [(1, 65536), (2, 65536), (3, 65536),
                                  (5, 65536), (64, 65536), (1, 4096),
                                  (9, 4096), (17, 4096), (64, 4096),
                                  (5, 1000)])
def test_runs_boundary_rows(cuda_device, setting, N, Bk):
    """match_runs equal to _match_runs_plain on chip_smoke.runs_rows (runs
    and ladder chains across the CTAs' slices), one launch a call, with
    the CTAs a row the launcher states: the largest power of two up to 16
    with N * K on the SMs and a tile a CTA, at least 2 with the ladder at
    B = 65,536."""
    offs, nw, ext = SMOKE.RUNS_SETTINGS[setting]
    data, best, n = (x.to(cuda_device) for x in SMOKE.runs_rows(
        N, Bk, nw, ext, seed=N + Bk + ext))
    before = match_find.launches["match_runs"]
    got = match_find.match_runs(data, best, n, Bk, offs, nw, ext)
    torch.cuda.synchronize()
    assert match_find.launches["match_runs"] == before + 1
    _eq(got, tdev._match_runs_plain(data, best, n, Bk, offs, nw, ext))
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    k = 1
    while 2 * k <= 16 and N * 2 * k <= sms and 2 * k <= -(-Bk // 32):
        k *= 2
    if ext and Bk == 65536:
        k = max(k, 2)
    assert match_find.runs_ctas(N, Bk, offs, nw, ext) == k


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
