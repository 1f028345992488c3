"""The port's zstd device decoder (aocl_compression_tpu_torch/ops/
zstd_decode_device.py): its stages against the JAX package's, and exact
decodes of the port's and host-made frames (tests/test_torch_zstd.py
decodes the JAX package's).

The stages run on plans from the port's runtime/native.zstd_frame_plan, at
a small block size (B = 4096) so each JAX function compiles once: the bit
reader (_read_back, _init_pos) over its edges, the two scans' plain loops
(the literal symbols below each lane's count; every sequence slot), and
make_decoder's whole output. Tolerance: exact equality. decode_frames and
decode_chunks (64 KiB output domain, as the codec runs them) must return
the input exactly; a skippable frame passes through, a size mismatch
raises, and frames the device does not take go through the host-decode
callable.

The JAX package is imported inside fixtures, so the card-only tests (each
scan kernel against its plain loop, decode on the card) also run where JAX
is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_zstd_decode.py
"""

import functools

import numpy as np
import pytest
import torch

from aocl_compression_tpu_torch.ops import zstd_decode_device as D
from aocl_compression_tpu_torch.ops import zstd_device as tdev
from aocl_compression_tpu_torch.runtime import native
from test_torch_zstd import BLOCKS, KINDS, _payload

B = 4096


class _Host:
    """The host-decode callable: the shared library's decoder, counted."""

    def __init__(self):
        self.calls = 0

    def __call__(self, frame: bytes) -> bytes:
        self.calls += 1
        return native.zstd_decompress(frame)


def _hosted(frames):
    """How many of the frames the device decoder leaves to the host: frames
    of more than one block, the uncompressed blocks, and those whose
    literal section exceeds its stream cap (raw literals of a 64 KiB
    block)."""
    sb = D._stream_caps(D.MAX_DEVICE_BLOCK)[0]
    plans = [native.zstd_frame_plan(f, 0, 1) for f in frames]
    return sum(nb != 1 or m[0][D.PM_BTYPE] != 2
               or int(m[0][D.PM_S0LEN:D.PM_S3LEN + 1:2].max()) > sb
               for nb, m, *_ in plans)


def _decode_frames(data, expected=None, device="cpu"):
    host = _Host()
    return D.decode_frames(data, expected, device=device,
                           host_decode=host), host.calls


@functools.lru_cache(maxsize=None)
def _sources():
    """name -> frames of BLOCKS: the port's encoder at levels 1 and 3, the
    host encoder at levels 1, 3 and 19."""
    out = {f"port{lvl}": tuple(tdev.encode_blocks(BLOCKS, lvl,
                                                  device="cpu")[0])
           for lvl in (1, 3)}
    for lvl in (1, 3, 19):
        out[f"host{lvl}"] = tuple(native.zstd_compress(b, lvl)
                                  for b in BLOCKS)
    return out


@functools.lru_cache(maxsize=None)
def _plans(names=("port1", "host3", "host19")):
    """The planned device blocks of the named sources' frames: (src, metas,
    hufs, fses)."""
    data = b"".join(f for n in names for f in _sources()[n])
    metas, hufs, fses = [], [], []
    off = 0
    while off < len(data):
        nb, meta, huf, fse, consumed = native.zstd_frame_plan(data, off, 1)
        if nb == 1 and meta[0][D.PM_BTYPE] == 2:
            metas.append(meta[0])
            hufs.append(huf[0].astype(np.int32))
            fses.append(fse[0].astype(np.int32))
        off += consumed
    return np.frombuffer(data, np.uint8), metas, hufs, fses


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def jdd():
    from aocl_compression_tpu.ops import zstd_decode_device
    return zstd_decode_device


@pytest.fixture(scope="module")
def jnp():
    import jax.numpy
    return jax.numpy


def test_read_back_and_init_pos(jdd, jnp):
    import jax
    rng = np.random.default_rng(1)
    L, W = 48, 6
    words = rng.integers(0, 1 << 32, (L, W), dtype=np.uint64)
    pos = np.r_[[0, 1, 5, 31, 32, 33, 191, 192], rng.integers(0, 193, L - 8)]
    nbits = np.r_[[0, 1, 11, 16, 31, 9, 17, 0], rng.integers(0, 32, L - 8)]
    pos, nbits = pos.astype(np.int32), nbits.astype(np.int32)
    ref = jax.jit(jdd._read_back)(jnp.asarray(words.astype(np.uint32)),
                                  jnp.asarray(pos), jnp.asarray(nbits))
    assert native._PLAN_STRIDE == D.PLAN_STRIDE   # the plan's row layout
    w = D._bytes_to_words(_t(words.astype(np.uint32)).view(torch.uint8)
                          .reshape(L, 4 * W))
    assert torch.equal(w, _t(words.astype(np.int64)))
    got = D._read_back(w, _t(pos).long(), _t(nbits))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    sbytes = rng.integers(0, 256, (L, 4 * W), dtype=np.uint8)
    sbytes[:4, :] = 0
    slen = rng.integers(0, 4 * W + 1, L).astype(np.int32)
    slen[:3] = [0, 1, 4 * W]
    ref = jax.jit(jdd._init_pos)(jnp.asarray(sbytes), jnp.asarray(slen))
    np.testing.assert_array_equal(
        D._init_pos(_t(sbytes), _t(slen)).numpy(), np.asarray(ref))


def test_read_back_past_the_row_matches_jax(jdd, jnp):
    """Reads that reach past a row's last word: the JAX package's
    take_along_axis fills a uint32 word past the end with UINT_MAX."""
    import jax
    rng = np.random.default_rng(2)
    L, W = 24, 3
    words = rng.integers(0, 1 << 32, (L, W), dtype=np.uint64)
    pos = rng.integers(32 * W - 20, 32 * W + 80, L).astype(np.int32)
    nbits = rng.integers(0, 32, L).astype(np.int32)
    ref = jax.jit(jdd._read_back)(jnp.asarray(words.astype(np.uint32)),
                                  jnp.asarray(pos), jnp.asarray(nbits))
    got = D._read_back(_t(words.astype(np.int64)), _t(pos).long(),
                       _t(nbits))
    assert (pos - nbits >= 32 * W).sum() > 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.fixture(scope="module")
def plan_batch():
    src, metas, hufs, fses = _plans()
    arrs, widths = D._plan_arrays(src, metas, B)
    return arrs, np.stack(hufs), np.stack(fses), widths


def test_scans_plain_match_jax(jdd, jnp, plan_batch):
    import jax
    (meta, sbytes, slens, scounts, qbytes, rawlit), huf, fse, (
        MAXL, MAXSEQ) = plan_batch
    N = len(meta)
    L = 4 * N
    SB = sbytes.shape[2]
    hlog = np.repeat(meta[:, D.PM_HUFLOG], 4)
    args = (sbytes.reshape(L, SB), slens.reshape(L), scounts.reshape(L),
            huf, hlog)
    ref = np.asarray(jax.jit(functools.partial(jdd._literal_scan, MAXL=MAXL))(
        *map(jnp.asarray, args))).astype(np.uint8)
    got = D._literal_scan(*map(_t, args), MAXL).numpy()
    live = np.arange(MAXL)[None] < scounts.reshape(L)[:, None]
    assert live.sum() > 10000
    np.testing.assert_array_equal(got[live], ref[live])

    sargs = (qbytes, meta[:, D.PM_SEQLEN], meta[:, D.PM_NBSEQ], fse,
             meta[:, D.PM_LLLOG], meta[:, D.PM_OFLOG], meta[:, D.PM_MLLOG])
    ref = jax.jit(functools.partial(jdd._sequence_scan, MAXSEQ=MAXSEQ))(
        *map(jnp.asarray, sargs))
    got = D._sequence_scan(*map(_t, sargs), MAXSEQ)
    assert int(meta[:, D.PM_NBSEQ].max()) > 100
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


_LIT_ADVERSARIAL = ["mutated_streams", "slens_edges", "slens_huge",
                    "hlog_edges", "counts_edges", "entry_bits"]


def _lit_adversarial(case, plan_batch, rng):
    """The literal scan's inputs (sbytes, slens, counts, huftab, huflog) of
    the planned batch as numpy arrays, made corrupt or edgy, and MAXL."""
    (meta, sbytes, slens, scounts, _, _), huf, _, (MAXL, _) = plan_batch
    L, SB = 4 * len(meta), sbytes.shape[2]
    sbytes = sbytes.reshape(L, SB).copy()
    slens = slens.reshape(L).astype(np.int32)
    counts = scounts.reshape(L).astype(np.int32)
    huf = huf.astype(np.int32)
    hlog = np.repeat(meta[:, D.PM_HUFLOG], 4).astype(np.int32)
    if case == "mutated_streams":  # bit flips inside each stream
        for i in range(L):
            for k in rng.integers(0, max(int(slens[i]), 1), 3):
                sbytes[i, k] ^= np.uint8(1 << rng.integers(0, 8))
    elif case in ("slens_edges", "slens_huge"):  # over random bytes
        sbytes[:] = rng.integers(0, 256, sbytes.shape, dtype=np.uint8)
        if case == "slens_edges":  # empty, one byte, the full row, past it
            slens[:] = rng.choice([0, 1, SB, SB + 5], L)
            slens[:4] = [0, 1, SB, SB + 5]
        else:  # a start bit past 2^31: positions must not wrap
            slens[::2] = (1 << 28) + 3
    elif case == "hlog_edges":
        hlog[:] = rng.choice([-1, 0, 12, 40], L)
        hlog[:4] = [-1, 0, 12, 40]
    elif case == "counts_edges":  # past MAXL and below 0
        counts[:] = np.where(rng.random(L) < 0.5,
                             rng.choice([MAXL + 37, -5], L), counts)
        counts[:2] = [MAXL + 37, -5]
    elif case == "entry_bits":  # entries that read 0 or 15 bits
        hit = rng.random(huf.shape) < 0.5
        huf = np.where(hit, (huf & ~15) | rng.choice([0, 15], huf.shape),
                       huf).astype(np.int32)
    return [sbytes, slens, counts, huf, hlog], MAXL


@functools.lru_cache(maxsize=None)
def _jax_literal_scan(MAXL):
    import jax
    from aocl_compression_tpu.ops import zstd_decode_device
    return jax.jit(functools.partial(zstd_decode_device._literal_scan,
                                     MAXL=MAXL))


# slens_huge is left out: there the JAX package's int32 bit positions wrap
# and the plain version's int64 ones do not
@pytest.mark.parametrize("case", [c for c in _LIT_ADVERSARIAL
                                  if c != "slens_huge"])
def test_literal_scan_plain_adversarial_matches_jax(jnp, plan_batch, case):
    """The plain literal scan against the JAX package's on the card test's
    corrupt and edge inputs, every slot below each lane's count."""
    rng = np.random.default_rng(_LIT_ADVERSARIAL.index(case))
    arrs, MAXL = _lit_adversarial(case, plan_batch, rng)
    ref = np.asarray(_jax_literal_scan(MAXL)(
        *map(jnp.asarray, arrs))).astype(np.uint8)
    got = D._literal_scan(*map(_t, arrs), MAXL).numpy()
    live = np.arange(MAXL)[None] < arrs[2][:, None]
    assert live.any()
    np.testing.assert_array_equal(got[live], ref[live])


def test_make_decoder_matches_jax(jdd, jnp, plan_batch):
    (meta, sbytes, slens, scounts, qbytes, rawlit), huf, fse, widths = \
        plan_batch
    args = (meta, huf, fse, sbytes, slens, scounts, qbytes, rawlit)
    caps = D._stream_caps(B)
    jo, jd = jdd.make_decoder(B, *caps, *widths)(*map(jnp.asarray, args))
    stages = []
    o, d = D.make_decoder(B, *caps, *widths)(*map(_t, args),
                                             mark=stages.append)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert stages[:3] == ["literal_scan", "literal_place", "sequence_scan"]
    assert stages[-2:] == ["resolve", "gather_output"]
    # every planned block decodes to its input
    outs = {o[i, :d[i]].numpy().tobytes() for i in range(len(d))}
    assert outs <= set(BLOCKS)


@pytest.mark.parametrize("source", ["port1", "port3", "host1", "host3",
                                    "host19"])
def test_decode_frames_and_chunks(source):
    frames = list(_sources()[source])
    data = b"".join(BLOCKS)
    assert _decode_frames(b"".join(frames), len(data))[0] == data
    host = _Host()
    outs = D.decode_chunks(frames, [len(b) for b in BLOCKS], device="cpu",
                           host_decode=host)
    assert outs == list(BLOCKS)
    # every frame is one block within 64 KiB: only the uncompressed blocks
    # (the random and the tiny ones) go to the host
    assert host.calls == _hosted(frames) == 4


def test_decode_64k_frames():
    """The tier's block size: 64 KiB blocks."""
    blocks = [_payload(k, 65536, s) for s, k in enumerate(KINDS)
              if k in ("text", "random", "high", "mixed")]
    frames = tdev.encode_blocks(blocks, 1, device="cpu")[0]
    data = b"".join(blocks)
    # to the host: the random block (stored raw) and the mixed one, whose
    # 36,624 raw literals exceed the device's stream cap (B/4 + 4096)
    assert _hosted(frames) == 2
    assert _decode_frames(b"".join(frames), len(data)) == (data, 2)


def test_skippable_frame_passes_through():
    frames = _sources()["port1"]
    skip = b"\x50\x2a\x4d\x18" + (5).to_bytes(4, "little") + b"12345"
    data = b"".join(BLOCKS[:3])
    got = _decode_frames(frames[0] + skip + frames[1] + frames[2], len(data))
    assert got == (data, 0)


def test_size_mismatch_raises():
    data = b"".join(BLOCKS)
    with pytest.raises(ValueError, match="size mismatch"):
        _decode_frames(b"".join(_sources()["port1"]), len(data) + 1)
    with pytest.raises(ValueError, match="corrupt"):
        _decode_frames(b"\x28\xb5\x2f\xfd\x00")


def test_frames_beyond_the_gate_go_to_the_host():
    """A frame over 64 KiB and a multi-block frame decode through the
    host-decode callable, beside device frames."""
    big = _payload("text", 100000, 3)
    multi = native.zstd_compress(_payload("mixed", 300000, 4), 1)
    small = _sources()["port1"][0]
    stream = small + native.zstd_compress(big, 3) + multi
    want = BLOCKS[0] + big + _payload("mixed", 300000, 4)
    assert _decode_frames(stream, len(want)) == (want, 2)


def test_stock_zstd_frames():
    zstandard = pytest.importorskip("zstandard")
    data = b"".join(BLOCKS)
    for lvl in (1, 3, 19):
        c = zstandard.ZstdCompressor(level=lvl).compress(data)
        assert _decode_frames(c, len(data))[0] == data


# --- card-only: the scan kernels against their plain loops -------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_scan_kernels_match_plain(cuda_device, plan_batch):
    from aocl_compression_tpu_torch.ops import zstd_scan
    (meta, sbytes, slens, scounts, qbytes, rawlit), huf, fse, (
        MAXL, MAXSEQ) = plan_batch
    L = 4 * len(meta)
    args = [_t(a) for a in (sbytes.reshape(L, -1), slens.reshape(L),
                            scounts.reshape(L), huf,
                            np.repeat(meta[:, D.PM_HUFLOG], 4))]
    want = D._literal_scan(*args, MAXL)
    got = D._literal_scan(*(a.to(cuda_device) for a in args), MAXL).cpu()
    live = torch.arange(MAXL)[None] < args[2][:, None]
    assert torch.equal(got[live], want[live])
    sargs = [_t(a) for a in (qbytes, meta[:, D.PM_SEQLEN],
                             meta[:, D.PM_NBSEQ], fse, meta[:, D.PM_LLLOG],
                             meta[:, D.PM_OFLOG], meta[:, D.PM_MLLOG])]
    n0 = zstd_scan.launches["fse_sequence_scan"]
    got = D._sequence_scan(*(a.to(cuda_device) for a in sargs), MAXSEQ)
    assert zstd_scan.launches["fse_sequence_scan"] == n0 + 1
    for g, w in zip(got, D._sequence_scan(*sargs, MAXSEQ)):
        assert torch.equal(g.cpu(), w)


_SEQ_ADVERSARIAL = ["mutated_qbytes", "qlens_edges", "states_outside",
                    "wide_reads", "nbseq_over_maxseq"]


def _seq_adversarial(case, plan_batch, rng):
    """The sequence scan's inputs (qbytes, qlens, nbseq, fsetab, lllog,
    oflog, mllog) of the planned batch, made corrupt or edgy, and MAXSEQ."""
    (meta, _, _, _, qbytes, _), _, fse, (_, MAXSEQ) = plan_batch
    qbytes, fse = qbytes.copy(), fse.copy()
    N, QB = qbytes.shape
    qlens = meta[:, D.PM_SEQLEN].astype(np.int32)
    nbseq = meta[:, D.PM_NBSEQ].astype(np.int32)
    logs = [meta[:, f].astype(np.int32).copy()
            for f in (D.PM_LLLOG, D.PM_OFLOG, D.PM_MLLOG)]
    if case == "mutated_qbytes":  # bit flips inside each section
        for i in range(N):
            for _ in range(3):
                k = rng.integers(0, max(int(qlens[i]), 1))
                qbytes[i, k] ^= np.uint8(1 << rng.integers(0, 8))
    elif case == "qlens_edges":  # empty, one byte, the full row, past it
        qbytes[:, :] = rng.integers(0, 256, qbytes.shape, dtype=np.uint8)
        qlens[:] = rng.choice([0, 1, QB, QB + 5], N)
        qlens[:4] = [0, 1, QB, QB + 5]
    elif case == "states_outside":  # next states and first states past 511
        base = rng.integers(-600, 1200, fse.shape)
        fse = ((base << 16) | (fse & 0xFFFF)).astype(np.int32)
        for lg in logs:
            lg[:] = rng.integers(-3, 13, N)
    elif case == "wide_reads":  # state reads of 17-40 bits: the cold path
        nb = rng.integers(0, 41, fse.shape)
        fse = ((fse & ~0xFF00) | (nb << 8)).astype(np.int32)
    elif case == "nbseq_over_maxseq":
        nbseq[:] = rng.integers(MAXSEQ - 5, MAXSEQ + 60, N)
        nbseq[0] = -3
    return [qbytes, qlens, nbseq, fse] + logs, MAXSEQ


@pytest.mark.cuda
@pytest.mark.parametrize("case", _SEQ_ADVERSARIAL)
def test_sequence_scan_matches_plain_adversarial(cuda_device, plan_batch,
                                                 case):
    """fse_sequence_scan against its plain loop, every slot (exact), on
    corrupt and edge lanes: mutated sections, qlens of 0, 1, the full row
    and past it, states outside [0, 512), state reads wider than 16 bits,
    and nbseq above MAXSEQ (and negative)."""
    rng = np.random.default_rng(_SEQ_ADVERSARIAL.index(case))
    arrs, MAXSEQ = _seq_adversarial(case, plan_batch, rng)
    sargs = [_t(a) for a in arrs]
    want = D._sequence_scan(*sargs, MAXSEQ)
    got = D._sequence_scan(*(a.to(cuda_device) for a in sargs), MAXSEQ)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _LIT_ADVERSARIAL)
def test_literal_scan_matches_plain_adversarial(cuda_device, plan_batch,
                                                case):
    """huf_literal_scan against its plain loop, every slot below each lane's
    count (exact), on mutated streams, slens of 0, 1, the full row, past it
    and past 2^28, hlog of -1, 0, 12 and 40, counts past MAXL and below 0,
    and entries of 0 and 15 bits."""
    rng = np.random.default_rng(_LIT_ADVERSARIAL.index(case))
    arrs, MAXL = _lit_adversarial(case, plan_batch, rng)
    args = [_t(a) for a in arrs]
    want = D._literal_scan(*args, MAXL)
    got = D._literal_scan(*(a.to(cuda_device) for a in args), MAXL).cpu()
    live = torch.arange(MAXL)[None] < args[2][:, None]
    assert torch.equal(got[live], want[live])


@pytest.mark.cuda
def test_decode_on_card(cuda_device):
    blocks = [_payload(k, 65536, s) for s, k in enumerate(KINDS)] + BLOCKS
    for frames in (tdev.encode_blocks(blocks, 1, device=cuda_device)[0],
                   [native.zstd_compress(b, 19) for b in blocks]):
        host = _Host()
        assert D.decode_chunks(frames, [len(b) for b in blocks],
                               device=cuda_device, host_decode=host) == blocks
        assert host.calls == _hosted(frames)
