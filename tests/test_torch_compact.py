"""Parity of the port's stream compactor (aocl_compression_tpu_torch/ops/
compact.py) with the JAX package's XLA compactor, plus the CUDA kernel
against its plain version where a card is present. Exact equality: the
compaction moves bytes.

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


def _cases():
    cases = [(N, OUTCAP, *_mk(N, OUTCAP)) for N, OUTCAP in SHAPES]
    bodies, _ = _mk(4, 512, seed=1)
    cases.append((4, 512, bodies, np.array([0, 512, 0, 77], np.int32)))
    return cases


CASES = _cases()
IDS = ["4x512", "8x1024", "3x2048", "zero_full"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_jax_compactor(case):
    import jax.numpy as jnp
    from aocl_compression_tpu.ops import compact as jcompact
    N, OUTCAP, bodies, sizes = case
    jd, joffs, jused = jcompact._make_compactor(N, OUTCAP, False)(
        jnp.asarray(bodies), jnp.asarray(sizes))
    jused = int(jused)
    dense, offs, used, _ = tcompact.compact_rows(torch.from_numpy(bodies),
                                                 torch.from_numpy(sizes))
    assert int(used) == jused
    np.testing.assert_array_equal(offs.numpy(), np.asarray(joffs))
    np.testing.assert_array_equal(dense[:jused].numpy(),
                                  np.asarray(jd)[:jused])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fetch_chunks_matches_jax(case):
    import jax.numpy as jnp
    from aocl_compression_tpu.ops import compact as jcompact
    N, OUTCAP, bodies, sizes = case
    chunks = tcompact.fetch_chunks(torch.from_numpy(bodies),
                                   torch.from_numpy(sizes))
    assert chunks == jcompact.fetch_chunks(jnp.asarray(bodies),
                                           jnp.asarray(sizes))
    assert chunks == [bodies[i, :sizes[i]].tobytes() for i in range(N)]


def test_round_capacity():
    assert tcompact.round_capacity(1) == 512
    assert tcompact.round_capacity(512) == 512
    assert tcompact.round_capacity(513) == 1024


def test_unaligned_capacity_rejected():
    with pytest.raises(ValueError):
        tcompact.fetch_chunks(torch.zeros((2, 500), dtype=torch.uint8),
                              torch.tensor([1, 2], dtype=torch.int32))


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_matches_plain(cuda_device, case):
    N, OUTCAP, bodies, sizes = case
    b = torch.from_numpy(bodies)
    s = torch.from_numpy(sizes)
    pd, poffs, pused, _ = tcompact.compact_rows(b, s)
    before = tcompact.launches
    kd, koffs, kused, _ = tcompact.compact_rows(b.to(cuda_device),
                                                s.to(cuda_device))
    torch.cuda.synchronize()
    assert tcompact.launches == before + 1
    used = int(pused)
    assert int(kused) == used
    assert torch.equal(koffs.cpu(), poffs)
    assert torch.equal(kd[:used].cpu(), pd[:used])
