"""The chain marking (ops/chain_scan.py, csrc/chain_scan.cu) and its plain
versions against the JAX package.

On the CPU the port's _chain_marks and _grid_select run their plain versions
(_chain_marks_plain, _reach_from_start_plain: matrix squarings); the same
seeded numpy rows go through the JAX functions (jitted and vmapped on the
CPU). The chain rows hold the edges the real chains never have: exits into
an earlier or the same segment, in-segment back and self edges and cycles,
targets below 0 and past C, exits exactly at C, clen = 0 and clen not a
multiple of 128. _greedy_parse (the exact parse's chain, as the LZ4 frame's
device tier marks a block) runs on seeded match candidates, _grid_select on
seeded candidates at the bench config's SUBM 64 / G = 8 and at M < 128.
Tolerance: exact equality on every output.

The JAX package is imported inside fixtures, so the card-only tests (each
kernel against its plain version, on these rows and on full 256-row
batches) also run where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_chain_scan.py
"""

import functools

import numpy as np
import pytest
import torch

from aocl_compression_tpu_torch.ops import lz4_device as tdev

SEG = 128


@pytest.fixture(scope="module")
def jax_mods():
    import jax
    import jax.numpy as jnp
    from aocl_compression_tpu.ops import lz4_device as jdev
    return jax, jnp, jdev


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(port, ref):
    np.testing.assert_array_equal(port.cpu().numpy(), np.asarray(ref))


def _minimal(C: int = 1024):
    """Forward steps of 5 and one exit back to position 10 from segment 2:
    JAX's in-order scan ends the chain there."""
    nxt = np.minimum(np.arange(C) + 5, C).astype(np.int32)
    nxt[300] = 10
    return nxt[None], np.array([C], np.int32)


def _chain_rows(C: int, seed: int):
    """(rows, C) int32 chains and their clen: token-like forward steps
    (clen = C, a clen not a multiple of 128, clen = 0, clen = 1), a literal
    run (every position), forward steps whose exits all land exactly at C
    from segment 1 on, forward chains with exits back to an earlier
    segment, exits to an earlier position of the same segment, in-segment
    back and self edges, an in-segment cycle, targets below 0 and past C,
    and random targets anywhere."""
    rng = np.random.default_rng(seed)
    idx = np.arange(C)
    S = C // SEG
    fwd = lambda hi: np.minimum(idx + rng.integers(1, hi, C), C)  # noqa
    rows, clens = [], []

    def add(nxt, clen=C):
        rows.append(np.asarray(nxt, np.int64))
        clens.append(clen)

    for clen in (C, C - 77, 0, 1):
        add(fwd(9), clen)
    add(np.minimum(idx + 1, C))
    at_c = fwd(40)
    at_c[SEG:] = C
    add(at_c)
    for k in (3, 12):
        back = fwd(200)
        where = rng.choice(C, k, replace=False)
        back[where] = rng.integers(0, C, k)
        add(back)
    same = fwd(60)
    p = rng.choice(C, 3 * S, replace=False)
    same[p] = (p // SEG) * SEG + rng.integers(0, SEG, p.size)
    add(same)
    selfb = fwd(30)
    p = rng.choice(C, 4 * S, replace=False)
    selfb[p[::2]] = p[::2]
    selfb[p[1::2]] = np.maximum(p[1::2] - rng.integers(1, 20, p[1::2].size),
                                (p[1::2] // SEG) * SEG)
    add(selfb, C - 5)
    cyc = fwd(7)
    s = rng.integers(0, S)
    seg = np.arange(s * SEG, (s + 1) * SEG)
    cyc[seg] = s * SEG + (seg - s * SEG + 1) % SEG
    add(cyc)
    wild = fwd(50)
    p = rng.choice(C, 2 * S, replace=False)
    wild[p[::2]] = -rng.integers(1, 1000, p[::2].size)
    wild[p[1::2]] = C + rng.integers(1, 1000, p[1::2].size)
    add(wild)
    add(rng.integers(-5, C + 6, C), C - 200)
    return np.array(rows, np.int32), np.array(clens, np.int32)


@functools.lru_cache(maxsize=None)
def _jax_chain(C: int):
    import jax
    from aocl_compression_tpu.ops import lz4_device as jdev
    return jax.jit(jax.vmap(functools.partial(jdev._chain_marks, C=C)))


def _jax_marks(jax_mods, nxt, clen):
    jnp = jax_mods[1]
    return np.asarray(_jax_chain(nxt.shape[1])(jnp.asarray(nxt),
                                               jnp.asarray(clen)))


def test_chain_marks_backward_exit_minimal(jax_mods):
    nxt, clen = _minimal()
    want = _jax_marks(jax_mods, nxt, clen)
    assert want.sum() == 61
    _eq(tdev._chain_marks(_t(nxt), _t(clen), nxt.shape[1]), want)


@pytest.mark.parametrize("C,seed", [(1024, 1), (4096, 2), (384, 3),
                                    (128, 4), (640, 7), (2560, 8),
                                    (1152, 9)])
def test_chain_marks_matches_jax(jax_mods, C, seed):
    nxt, clen = _chain_rows(C, seed)
    want = _jax_marks(jax_mods, nxt, clen)
    assert not want[2].any()                  # clen = 0
    assert want[4].all()                      # the literal run
    _eq(tdev._chain_marks(_t(nxt), _t(clen), C), want)


@pytest.mark.parametrize("B,seed", [(4096, 11), (2048, 12)])
def test_greedy_parse_matches_jax(jax_mods, B, seed):
    """The exact parse's greedy chain (next = i + mlen at a match, else
    i + 1), as the LZ4 frame's device tier marks one block: long literal
    runs, dense and sparse matches, matches past the block's end."""
    jax, jnp, jdev = jax_mods
    rng = np.random.default_rng(seed)
    mlen = rng.integers(4, 300, (4, B)).astype(np.int32)
    mlen[1] = rng.integers(4, 12, B)
    valid = rng.random((4, B)) < np.array([0.02, 0.5, 0.9, 0.2])[:, None]
    valid[3, : B // 2] = False
    fn = jax.jit(jax.vmap(functools.partial(jdev._greedy_parse, B=B)))
    want = np.asarray(fn(jnp.asarray(mlen), jnp.asarray(valid)))
    _eq(tdev._greedy_parse(_t(mlen), _t(valid), B), want)
    assert want[3, : B // 2].all()


def _candidates(N: int, B: int, seed: int):
    """Seeded (mlen, moff, valid) rows for _grid_select: match lengths
    from 4 to 300, sparse and dense valid positions."""
    rng = np.random.default_rng(seed)
    mlen = rng.integers(4, 300, (N, B)).astype(np.int32)
    mlen[::2] = rng.integers(4, 24, (N - N // 2, B))
    moff = rng.integers(1, 65536, (N, B)).astype(np.int32)
    valid = rng.random((N, B)) < np.linspace(0.02, 0.6, N)[:, None]
    return mlen, moff, valid


@pytest.mark.parametrize("B,G,subm,cap", [(4096, 8, 64, 88),
                                          (512, 8, 128, 24),
                                          (256, 4, 128, 0)])
def test_grid_select_matches_jax(jax_mods, B, G, subm, cap):
    jax, jnp, jdev = jax_mods
    mlen, moff, valid = _candidates(6, B, B + G)
    fn = jax.jit(jax.vmap(functools.partial(
        jdev._grid_select, B=B, G=G, subm=subm, match_cap=cap)))
    want = fn(jnp.asarray(mlen), jnp.asarray(moff), jnp.asarray(valid))
    got = tdev._grid_select(_t(mlen), _t(moff), _t(valid), B, G, subm=subm,
                            match_cap=cap)
    for g, w in zip(got, want):
        _eq(g, w)
    assert np.asarray(want[0]).sum() > 0


def test_chain_scans_reject_other_devices():
    from aocl_compression_tpu_torch.ops import chain_scan
    meta = torch.empty((2, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tdev._chain_marks(meta, torch.empty(2, dtype=torch.int32,
                                            device="meta"), 256)
    with pytest.raises(ValueError):
        tdev._reach_from_start(meta, 128)
    cpu = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        chain_scan.chain_marks(cpu, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        chain_scan.subchain_reach(cpu, 128)


# --- the kernels against their plain versions (card only) -----------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _reach_rows(M: int, subm: int, seed: int):
    """(rows, M) int32 tile chains for subchain_reach: forward steps, exits
    at the sub-chain's end, back and self edges, cycles, targets below 0
    and past M."""
    rng = np.random.default_rng(seed)
    idx = np.arange(M)
    base = (idx // subm) * subm
    rows = [idx + 1, idx + rng.integers(1, 5, M),
            base + rng.integers(0, subm, M),
            base + (idx - base + 1) % subm,
            rng.integers(-3, M + 4, M), idx.copy()]
    mixed = idx + rng.integers(1, 9, M)
    p = rng.choice(M, M // 8, replace=False)
    mixed[p] = base[p] + rng.integers(0, subm, p.size)
    rows.append(mixed)
    return np.array(rows, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("M,subm", [(1024, 128), (512, 64), (64, 64),
                                    (96, 32), (120, 5)])
def test_subchain_reach_kernel_matches_plain(cuda_device, M, subm):
    from aocl_compression_tpu_torch.ops import chain_scan
    nxt = _t(_reach_rows(M, subm, M + subm))
    want = tdev._reach_from_start_plain(nxt, subm)
    n0 = chain_scan.launches["subchain_reach"]
    got = tdev._reach_from_start(nxt.to(cuda_device), subm)
    torch.cuda.synchronize()
    assert chain_scan.launches["subchain_reach"] == n0 + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("C,seed", [(1024, 1), (4096, 2), (384, 3),
                                    (128, 4), (81920, 5)])
def test_chain_marks_kernel_matches_plain(cuda_device, C, seed):
    """The rows of _chain_rows; C = 81,920 spans two and a half of the
    kernel's 32,768-position windows. The plain version runs on the card."""
    from aocl_compression_tpu_torch.ops import chain_scan
    nxt, clen = (_t(x).to(cuda_device) for x in _chain_rows(C, seed))
    want = tdev._chain_marks_plain(nxt, clen, C)
    n0 = chain_scan.launches["chain_marks"]
    got = tdev._chain_marks(nxt, clen, C)
    torch.cuda.synchronize()
    assert chain_scan.launches["chain_marks"] == n0 + 1
    assert torch.equal(got, want)


def _row_batches(rows, clens, N: int):
    """The rows in batches of N, in turn (the last batch wraps around)."""
    n = len(rows)
    for b in range(0, n, N):
        sel = [(b + i) % n for i in range(N)]
        yield rows[sel], clens[sel]


@pytest.mark.cuda
@pytest.mark.parametrize("C", [128, 4096, 65536, 81920])
@pytest.mark.parametrize("N", [1, 2, 7, 133])
def test_chain_marks_kernel_launch_configs(cuda_device, N, C):
    """chain_marks at batch sizes that take each launch configuration: a
    cluster of 8 CTAs a row (N = 1, 2, 7; the shares' guessed chains
    meet the true one or not, exits land in later shares or end the
    chain), and one CTA a row once two a row would pass the card's 132
    SMs (N = 133); C = 128 (one segment, a cluster of 1), 4,096, the
    frame path's 65,536 and 81,920 (two and a half windows). The rows of
    _chain_rows (seeds 20 on); the plain version runs on the card."""
    from aocl_compression_tpu_torch.ops import chain_scan
    sets = [_chain_rows(C, 20 + k) for k in range(-(-N // 13))]
    rows = np.concatenate([r for r, _ in sets])
    clens = np.concatenate([c for _, c in sets])
    for nxt, clen in _row_batches(rows, clens, N):
        nxt, clen = _t(nxt).to(cuda_device), _t(clen).to(cuda_device)
        want = tdev._chain_marks_plain(nxt, clen, C)
        n0 = chain_scan.launches["chain_marks"]
        got = tdev._chain_marks(nxt, clen, C)
        torch.cuda.synchronize()
        assert chain_scan.launches["chain_marks"] == n0 + 1
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("M,subm", [(16384, 128), (8192, 64), (1270, 127),
                                    (96, 6)])
@pytest.mark.parametrize("N", [1, 5, 133])
def test_subchain_reach_kernel_launch_configs(cuda_device, N, M, subm):
    """subchain_reach at batch sizes whose sub-chains fill part of a warp's
    32, whole blocks and more than one wave, at SUBM 128, 64, 127 and 6
    (not multiples of 4 take the word-at-a-time staging)."""
    rows = _reach_rows(M, subm, N + M + subm)
    nxt = _t(rows[[i % len(rows) for i in range(N)]]).to(cuda_device)
    want = tdev._reach_from_start_plain(nxt, subm)
    got = tdev._reach_from_start(nxt, subm)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernels_match_plain_full_batch(cuda_device):
    """256 rows of 65,536: the lz4hc greedy chain (token-like steps, a
    literal-run block) for chain_marks, and the main path's tile domain
    (M = 16,384, SUBM 128) and the bench config's (8,192, 64) for
    subchain_reach; the plain versions run on the card."""
    N, C = 256, 65536
    g = torch.Generator(device=cuda_device).manual_seed(13)
    idx = torch.arange(C, device=cuda_device, dtype=torch.int32)
    step = torch.randint(1, 40, (N, C), generator=g, device=cuda_device,
                         dtype=torch.int32)
    step[::7] = 1
    nxt = torch.clamp(idx + step, max=C)
    clen = torch.full((N,), C, dtype=torch.int32, device=cuda_device)
    clen[1::5] = C - 4097
    assert torch.equal(tdev._chain_marks(nxt, clen, C),
                       tdev._chain_marks_plain(nxt, clen, C))
    for M, subm in ((16384, 128), (8192, 64)):
        t = nxt[:, :M] // (C // M)
        assert torch.equal(tdev._reach_from_start(t, subm),
                           tdev._reach_from_start_plain(t, subm))


@pytest.mark.cuda
def test_kernels_take_unaligned_rows(cuda_device):
    """Inputs that start 4 bytes past an allocation (a contiguous view with
    an offset): chain_marks' wrapper copies them to an aligned buffer for
    its 16-byte loads, subchain_reach reads them a word at a time."""
    nxt, clen = (_t(x).to(cuda_device) for x in _chain_rows(4096, 6))
    flat = torch.empty(nxt.numel() + 1, dtype=torch.int32,
                       device=cuda_device)
    off = flat[1:].view(nxt.shape)
    off.copy_(nxt)
    assert off.data_ptr() % 16
    assert torch.equal(tdev._chain_marks(off, clen, 4096),
                       tdev._chain_marks_plain(nxt, clen, 4096))
    t = _t(_reach_rows(1024, 128, 7)).to(cuda_device)
    flat = torch.empty(t.numel() + 1, dtype=torch.int32, device=cuda_device)
    off = flat[1:].view(t.shape)
    off.copy_(t)
    assert torch.equal(tdev._reach_from_start(off, 128),
                       tdev._reach_from_start_plain(t, 128))
