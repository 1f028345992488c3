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
