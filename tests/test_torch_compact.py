"""Parity of the port's stream compactor (aocl_compression_tpu_torch/ops/
compact.py) with the JAX package's XLA compactor, plus the CUDA kernels
against their plain version where a card is present. Exact equality: the
compaction moves bytes.

The port clamps sizes to OUTCAP before its layout (a flagged block's body
may exceed the padded capacity); the JAX compactor does not, so it is fed
the clamped sizes.

The JAX package is imported inside the tests that use it, so the card-only
tests also run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_compact.py
"""

import numpy as np
import pytest
import torch

from aocl_compression_tpu_torch.ops import compact as tcompact

SHAPES = [(4, 512), (8, 1024), (3, 2048)]


def _mk(N, OUTCAP, seed=0):
    rng = np.random.default_rng(seed)
    bodies = rng.integers(0, 256, (N, OUTCAP), dtype=np.uint8)
    sizes = rng.integers(0, OUTCAP + 1, N).astype(np.int32)
    return bodies, sizes


def _mk_edges(N, OUTCAP, seed=3):
    """Random sizes in [0, 1.5 OUTCAP] that include 0, 1, OUTCAP - 1,
    OUTCAP and OUTCAP + 1 (the edges of the row quantum and the clamp)."""
    rng = np.random.default_rng(seed)
    bodies = rng.integers(0, 256, (N, OUTCAP), dtype=np.uint8)
    sizes = rng.integers(0, OUTCAP * 3 // 2 + 1, N).astype(np.int32)
    edges = np.array([0, 1, OUTCAP - 1, OUTCAP, OUTCAP + 1, 0], np.int32)
    k = min(N, len(edges))
    sizes[rng.choice(N, k, replace=False)] = edges[:k]
    return bodies, sizes


def _cases():
    cases = [(N, OUTCAP, *_mk(N, OUTCAP)) for N, OUTCAP in SHAPES]
    bodies, _ = _mk(4, 512, seed=1)
    cases.append((4, 512, bodies, np.array([0, 512, 0, 77], np.int32)))
    cases.append((3000, 512, *_mk_edges(3000, 512)))
    bodies, _ = _mk(64, 1024, seed=4)
    cases.append((64, 1024, bodies, np.zeros(64, np.int32)))
    cases.append((64, 1024, bodies, np.full(64, 1024, np.int32)))
    # the exact encoder's rows (out_capacity(65536) = 129 rows of 512 B)
    # and the decoder's full 64 KiB rows
    cases.append((6, 66048, *_mk_edges(6, 66048, seed=8)))
    bodies, _ = _mk(3, 65536, seed=9)
    cases.append((3, 65536, bodies, np.array([65536, 65536, 1000],
                                             np.int32)))
    # the deflate encoders' rows (74240 = 145 rows) and the snappy exact
    # encoder's (76800 = 150 rows)
    cases.append((6, 74240, *_mk_edges(6, 74240, seed=10)))
    cases.append((6, 76800, *_mk_edges(6, 76800, seed=11)))
    return cases


CASES = _cases()
IDS = ["4x512", "8x1024", "3x2048", "zero_full", "3000x512_edges",
       "all_zero", "all_full", "6x66048_edges", "3x65536_decode",
       "6x74240_deflate_edges", "6x76800_snappy_exact_edges"]


def _jax_compact(N, OUTCAP, bodies, sizes):
    import jax.numpy as jnp
    from aocl_compression_tpu.ops import compact as jcompact
    clamped = np.clip(sizes, 0, OUTCAP).astype(np.int32)
    jd, joffs, jused = jcompact._make_compactor(N, OUTCAP, False)(
        jnp.asarray(bodies), jnp.asarray(clamped))
    return np.asarray(jd), np.asarray(joffs), int(jused), clamped


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_jax_compactor(case):
    N, OUTCAP, bodies, sizes = case
    jd, joffs, jused, clamped = _jax_compact(N, OUTCAP, bodies, sizes)
    dense, offs, used, sz = tcompact.compact_rows(torch.from_numpy(bodies),
                                                  torch.from_numpy(sizes))
    assert int(used) == jused
    np.testing.assert_array_equal(offs.numpy(), joffs)
    np.testing.assert_array_equal(sz.numpy(), clamped)
    np.testing.assert_array_equal(dense[:jused].numpy(), jd[:jused])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fetch_chunks_matches_jax(case):
    import jax.numpy as jnp
    from aocl_compression_tpu.ops import compact as jcompact
    N, OUTCAP, bodies, sizes = case
    chunks = tcompact.fetch_chunks(torch.from_numpy(bodies),
                                   torch.from_numpy(sizes))
    clamped = np.clip(sizes, 0, OUTCAP).astype(np.int32)
    assert chunks == jcompact.fetch_chunks(jnp.asarray(bodies),
                                           jnp.asarray(clamped))
    assert chunks == [bodies[i, :sizes[i]].tobytes() for i in range(N)]


def test_plain_meta_layout():
    """meta is [used, row_offs, sz]; compact_rows returns views of it."""
    bodies, sizes = _mk_edges(300, 1024, seed=5)
    dense, meta = tcompact.compact_rows_plain(torch.from_numpy(bodies),
                                              torch.from_numpy(sizes))
    sz = np.clip(sizes, 0, 1024)
    rows = -(-sz // 512)
    offs = np.cumsum(rows) - rows
    np.testing.assert_array_equal(
        meta.numpy(), np.concatenate([[rows.sum()], offs, sz]))
    assert meta.dtype == torch.int32 and dense.shape == (300 * 2, 128)


def test_round_capacity():
    assert tcompact.round_capacity(1) == 512
    assert tcompact.round_capacity(512) == 512
    assert tcompact.round_capacity(513) == 1024


def test_unaligned_capacity_rejected():
    with pytest.raises(ValueError):
        tcompact.fetch_chunks(torch.zeros((2, 500), dtype=torch.uint8),
                              torch.tensor([1, 2], dtype=torch.int32))


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never runs the plain version: a CPU tensor is
    refused before anything is built or launched."""
    bodies, sizes = _mk(4, 512)
    with pytest.raises(ValueError):
        tcompact.compact_rows_kernel(torch.from_numpy(bodies),
                                     torch.from_numpy(sizes))


def test_single_row_slice_of_wider_buffer():
    """One row cut from a wider buffer (an emitter's spare scatter slot)
    reports contiguous with a row stride other than OUTCAP; the
    compaction reads it as dense rows."""
    wide = torch.from_numpy(_mk(1, 1024 + 1, seed=12)[0])
    bodies = wide[:, :1024]
    assert bodies.is_contiguous() and bodies.stride(0) == 1025
    sizes = torch.tensor([700], dtype=torch.int32)
    assert tcompact.fetch_chunks(bodies, sizes) == [
        wide[0, :700].numpy().tobytes()]


def test_oversize_body_clamped_to_capacity():
    """A flagged block's body may exceed the padded capacity; the layout
    clamps it so no copy leaves its chunk."""
    bodies, _ = _mk(3, 512, seed=2)
    sizes = np.array([600, 100, 512], np.int32)
    chunks = tcompact.fetch_chunks(torch.from_numpy(bodies),
                                   torch.from_numpy(sizes))
    assert chunks == [bodies[0].tobytes(), bodies[1, :100].tobytes(),
                      bodies[2].tobytes()]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_vs_plain(dev, bodies, sizes):
    """Kernel against plain, output for output: dense[:used] and meta
    ([used, row_offs, sz])."""
    b = torch.from_numpy(bodies)
    s = torch.from_numpy(sizes)
    pd, pmeta = tcompact.compact_rows_plain(b, s)
    kd, kmeta = tcompact.compact_rows_kernel(b.to(dev), s.to(dev))
    torch.cuda.synchronize()
    used = int(pmeta[0])
    assert torch.equal(kmeta.cpu(), pmeta)
    assert torch.equal(kd[:used].cpu(), pd[:used])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_matches_plain(cuda_device, case):
    N, OUTCAP, bodies, sizes = case
    b = torch.from_numpy(bodies)
    s = torch.from_numpy(sizes)
    pd, poffs, pused, psz = tcompact.compact_rows(b, s)
    before = tcompact.launches
    kd, koffs, kused, ksz = tcompact.compact_rows(b.to(cuda_device),
                                                  s.to(cuda_device))
    torch.cuda.synchronize()
    assert tcompact.launches == before + 2
    used = int(pused)
    assert int(kused) == used
    assert torch.equal(koffs.cpu(), poffs)
    assert torch.equal(ksz.cpu(), psz)
    assert torch.equal(kd[:used].cpu(), pd[:used])


CUDA_SHAPES = [(1, 512), (255, 512), (257, 512), (16384, 512),
               (65536, 512), (256, 65536)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES,
                         ids=[f"{n}x{c}" for n, c in CUDA_SHAPES])
def test_kernel_matches_plain_edges(cuda_device, shape):
    N, OUTCAP = shape
    _kernel_vs_plain(cuda_device, *_mk_edges(N, OUTCAP, seed=N))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 66048), (256, 65536), (256, 74240),
                                   (256, 76800)],
                         ids=["256x66048_exact_encode", "256x65536_decode",
                              "256x74240_deflate", "256x76800_snappy_exact"])
def test_kernel_matches_plain_slice_shapes(cuda_device, shape):
    """The lz4 exact encoder's 129-row chunks, the deflate encoders' 145
    rows and the snappy exact encoder's 150 rows (sizes at the row and
    clamp edges), and the decoders' full 64 KiB rows (every row used)."""
    N, OUTCAP = shape
    bodies, sizes = _mk_edges(N, OUTCAP, seed=OUTCAP)
    if OUTCAP == 65536:
        sizes = np.full(N, OUTCAP, np.int32)
    _kernel_vs_plain(cuda_device, bodies, sizes)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["zero", "full"])
def test_kernel_matches_plain_uniform(cuda_device, fill):
    bodies, _ = _mk(257, 2048, seed=6)
    sizes = np.full(257, 0 if fill == "zero" else 2048, np.int32)
    _kernel_vs_plain(cuda_device, bodies, sizes)


@pytest.mark.cuda
def test_kernel_reads_strided_sizes(cuda_device):
    """The encoder's sizes are a column of its cumsum (stride > 1); the
    layout kernel reads them in place."""
    bodies, sizes = _mk_edges(300, 1024, seed=7)
    wide = torch.zeros((300, 5), dtype=torch.int32)
    wide[:, -1] = torch.from_numpy(sizes)
    col = wide.to(cuda_device)[:, -1]
    assert col.stride(0) == 5
    pd, pmeta = tcompact.compact_rows_plain(torch.from_numpy(bodies),
                                            torch.from_numpy(sizes))
    kd, kmeta = tcompact.compact_rows_kernel(
        torch.from_numpy(bodies).to(cuda_device), col)
    assert torch.equal(kmeta.cpu(), pmeta)
    used = int(pmeta[0])
    assert torch.equal(kd[:used].cpu(), pd[:used])


@pytest.mark.cuda
def test_kernel_launches_per_call(cuda_device):
    """Two launches per compact_rows call (layout scan + copy)."""
    bodies, sizes = _mk(8, 1024)
    b = torch.from_numpy(bodies).to(cuda_device)
    s = torch.from_numpy(sizes).to(cuda_device)
    before = tcompact.launches
    for _ in range(3):
        tcompact.compact_rows(b, s)
    torch.cuda.synchronize()
    assert tcompact.launches == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fetch_chunks_cuda_matches_cpu(cuda_device, case):
    """The pinned fetch returns the same chunks as the CPU path."""
    N, OUTCAP, bodies, sizes = case
    b = torch.from_numpy(bodies)
    s = torch.from_numpy(sizes)
    assert tcompact.fetch_chunks(b.to(cuda_device), s.to(cuda_device)) == \
        tcompact.fetch_chunks(b, s)


@pytest.mark.cuda
def test_oversize_body_clamped_cuda(cuda_device):
    bodies, _ = _mk(3, 512, seed=2)
    sizes = np.array([600, 100, 512], np.int32)
    chunks = tcompact.fetch_chunks(torch.from_numpy(bodies).to(cuda_device),
                                   torch.from_numpy(sizes).to(cuda_device))
    assert chunks == [bodies[0].tobytes(), bodies[1, :100].tobytes(),
                      bodies[2].tobytes()]


@pytest.mark.cuda
def test_torch_cap_runs_no_compaction_kernel(cuda_device, monkeypatch):
    """Under AOCL_ENABLE_INSTRUCTIONS=TORCH the fetch runs the plain
    compaction on the card (the JAX package's fetch_chunks_xla): the
    kernels' count stays 0, and the chunks and an lz4 stream through the
    API are unchanged."""
    import aocl_compression_tpu_torch as act
    bodies, sizes = _mk_edges(300, 1024, seed=12)
    b = torch.from_numpy(bodies).to(cuda_device)
    s = torch.from_numpy(sizes).to(cuda_device)
    data = (b"the block hash match stream " * 3000)[:3 * 65536 - 77]
    monkeypatch.delenv("AOCL_ENABLE_INSTRUCTIONS", raising=False)
    h = act.setup("lz4", opt_var=2, block_size=65536, device=cuda_device)
    want, want_c = tcompact.fetch_chunks(b, s), act.compress(h, data)
    monkeypatch.setenv("AOCL_ENABLE_INSTRUCTIONS", "TORCH")
    tcompact.launches = 0
    assert tcompact.fetch_chunks(b, s) == want
    assert act.compress(h, data) == want_c
    torch.cuda.synchronize()
    assert tcompact.launches == 0
