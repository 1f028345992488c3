"""The port's multi-device tier (parallel/sharded.py, parallel/distributed.py,
parallel/dryrun.py and the *_multi variants) against the JAX package's mesh
tier and the port's single-device tier.

The JAX package runs on its 8 virtual CPU devices with
AOCL_ENABLE_INSTRUCTIONS=MESH; the port on virtual shards of the CPU
(device="cpu"). Streams, bodies, tails and tables are compared exactly:
the pipelines are integer-only with unique sort keys, so sharding must not
change a byte. The JAX package is imported inside the tests that use it, so
the card-only tests also run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_multi.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import aocl_compression_tpu_torch as act
from aocl_compression_tpu_torch.codecs import lz4 as tlz4
from aocl_compression_tpu_torch.codecs import lz4_stitch
from aocl_compression_tpu_torch.codecs import snappy as tsnappy
from aocl_compression_tpu_torch.codecs import zlib_bzip2_lzma as tzlib
from aocl_compression_tpu_torch.codecs import zstd as tzstd
from aocl_compression_tpu_torch.ops import compact, lz4_device
from aocl_compression_tpu_torch.parallel import distributed, dryrun, sharded
from aocl_compression_tpu_torch.utils import dispatch
from aocl_compression_tpu_torch.utils.config import TIER_MULTI

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 4096


def _data(n_full: int = 6, tail: int = 1000, seed: int = 3) -> bytes:
    """n_full blocks of BS and a short last block: words, then a random
    stretch in the fourth block."""
    rng = np.random.default_rng(seed)
    words = [b"the mesh ", b"shard ", b"of blocks ", b"compression "]
    text = b"".join(words[i] for i in rng.integers(0, 4, 3 * n_full * BS))
    n = n_full * BS + tail
    rnd = rng.integers(0, 256, BS // 2, dtype=np.uint8).tobytes()
    return (text[:3 * BS] + rnd + text)[:n]


DATA = _data()
BLOCKS = [DATA[i:i + BS] for i in range(0, len(DATA), BS)]   # 7, last short

# codec label -> (setup method, setup kwargs, MULTI variant, TORCH variant,
# the variants' second argument: accel or level)
CODECS = {
    "lz4": ("lz4", {}, tlz4._compress_blocks_multi,
            tlz4._compress_blocks_torch, 2),
    "snappy": ("snappy", {}, tsnappy._compress_blocks_multi,
               tsnappy._compress_blocks_torch, 2),
    "zlib1": ("zlib", dict(level=1), tzlib._zlib_compress_blocks_multi,
              tzlib._zlib_compress_blocks_torch, 1),
    "zlib2": ("zlib", dict(level=2), tzlib._zlib_compress_blocks_multi,
              tzlib._zlib_compress_blocks_torch, 2),
    "zstd1": ("zstd", dict(level=1), tzstd._compress_blocks_multi,
              tzstd._compress_blocks_torch, 1),
}


def _variant_call(fn, label, blocks, device, **kw):
    """A compress_blocks variant with the codec's second argument (zstd's
    dictionary is the third)."""
    arg = CODECS[label][4]
    if label == "zstd1":
        return fn(blocks, arg, None, device, **kw)
    return fn(blocks, arg, device, **kw)


def _audited(fn):
    dispatch.enable_audit(True)
    try:
        out = fn()
        return out, dispatch.audit_hits()
    finally:
        dispatch.enable_audit(False)


@pytest.fixture
def mesh_env(monkeypatch):
    """Both packages' caps at their top tier (MESH is the port's MULTI)."""
    monkeypatch.setenv("AOCL_ENABLE_INSTRUCTIONS", "MESH")


# --- parallel/sharded.py ------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_compress_blocks_multi_matches_jax_mesh(mesh_env, shards):
    """7 blocks of 4 KiB with a short last one: at 2-4 shards the last
    shard is uneven (at 4 it holds the short block alone)."""
    from aocl_compression_tpu.parallel import sharded as jsharded
    ref = jsharded.compress_blocks_mesh(BLOCKS, 2, shards)
    got = sharded.compress_blocks_multi(BLOCKS, 2, shards, device="cpu")
    assert got == (ref[0], ref[1])
    assert got == tlz4._device_bodies(BLOCKS, 2, "cpu")


@pytest.mark.parametrize("label", ["snappy", "zlib1", "zlib2", "zstd1"])
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_sharded_block_call_matches_single_device(label, shards):
    """Each codec's MULTI variant (sharded_block_call) at 1-3 shards equals
    its TORCH variant, chunk for chunk (4 shards against the JAX mesh tier:
    test_setup_multi_stream_matches_jax_mesh_and_torch)."""
    multi, torch_tier = CODECS[label][2:4]
    got = _variant_call(multi, label, BLOCKS, "cpu", num_shards=shards)
    assert got == _variant_call(torch_tier, label, BLOCKS, "cpu")


@pytest.mark.parametrize("label", list(CODECS))
def test_every_shard_encodes_at_the_batch_bucket(monkeypatch, label):
    """The shard holding the short last block encodes at the batch's
    bucket, as the JAX mesh tier's one padded batch does: the bucket sets
    G, OUTCAP and MAXSEQ, so a shard at its own smaller bucket could
    encode at another geometry."""
    seen = []
    upload = lz4_device.upload_blocks

    def spy(blocks, accel, device, mark, bucket=None):
        out = upload(blocks, accel, device, mark, bucket)
        seen.append((len(blocks), out[2]))
        return out

    monkeypatch.setattr(lz4_device, "upload_blocks", spy)
    _variant_call(CODECS[label][2], label, BLOCKS, "cpu", num_shards=4)
    assert seen == [(2, BS), (2, BS), (2, BS), (1, BS)]


@pytest.mark.parametrize("label", list(CODECS))
def test_setup_multi_stream_matches_jax_mesh_and_torch(monkeypatch, label):
    import aocl_compression_tpu as actpu
    method, kw = CODECS[label][:2]
    monkeypatch.setenv("AOCL_ENABLE_INSTRUCTIONS", "MESH")
    ref = actpu.compress(actpu.setup(method, num_shards=4, opt_var=2,
                                     block_size=BS, **kw), DATA)
    h = act.setup(method, num_shards=4, opt_var=2, block_size=BS,
                  device="cpu", **kw)
    c, hits = _audited(lambda: act.compress(h, DATA))
    assert c == ref
    assert hits[f"{method}_compress_blocks_multi"] == 1
    # the port fetches each shard through the compaction (the JAX mesh
    # tier copies the whole body buffer to the host and names no fetch):
    # once a shard, twice for zstd (literal streams, sequence sections)
    assert hits["fetch_chunks_kernel"] == (8 if method == "zstd" else 4)
    assert act.decompress(h, c) == DATA
    monkeypatch.setenv("AOCL_ENABLE_INSTRUCTIONS", "XLA")
    c_torch, hits = _audited(lambda: act.compress(h, DATA))
    assert c_torch == c
    assert hits[f"{method}_compress_blocks_torch"] == 1


@pytest.mark.parametrize("cap", ["TORCH", "XLA", "PALLAS"])
def test_env_cap_blocks_multi(monkeypatch, cap):
    monkeypatch.setenv("AOCL_ENABLE_INSTRUCTIONS", cap)
    h = act.setup("lz4", num_shards=4, opt_var=2, block_size=BS,
                  device="cpu")
    c, hits = _audited(lambda: act.compress(h, DATA))
    assert "lz4_compress_blocks_multi" not in hits
    assert dispatch.validate_tier_access(TIER_MULTI - 1)
    assert act.decompress(h, c) == DATA


def test_lz4_mem_limit_multi_equals_unsplit(mesh_env):
    h = act.setup("lz4", num_shards=3, opt_var=2, block_size=BS,
                  mem_limit=3 * BS, device="cpu")
    c, hits = _audited(lambda: act.compress(h, DATA))
    assert hits["lz4_compress_blocks_multi"] == 1
    # groups of 3, 3 and 1 blocks: 3 + 3 + 1 shards fetched
    assert hits["fetch_chunks_kernel"] == 7
    whole = act.setup("lz4", num_shards=3, opt_var=2, block_size=BS,
                      device="cpu")
    assert c == act.compress(whole, DATA)
    assert act.decompress(h, c) == DATA


def test_lz4_multi_decode(mesh_env, monkeypatch):
    monkeypatch.setenv("AOCL_DEVICE_DECODE", "1")
    h = act.setup("lz4", num_shards=4, opt_var=2, block_size=BS,
                  device="cpu")
    c = act.compress(h, DATA)
    d, hits = _audited(lambda: act.decompress(h, c))
    assert d == DATA
    assert hits["lz4_decompress_blocks_multi"] == 1
    assert "lz4_decompress_blocks_host" not in hits
    chunks, dlens = lz4_stitch.stitch_bodies(
        *tlz4._device_bodies(BLOCKS, 2, "cpu"), BLOCKS)
    for shards in (2, 3):
        assert sharded.decompress_blocks_multi(
            chunks, dlens, BS, shards, device="cpu") == \
            lz4_device.decode_blocks(chunks, dlens, BS, device="cpu")


def test_multi_decode_raises_past_64k():
    with pytest.raises(ValueError):
        sharded.decompress_blocks_multi([b"\x00"] * 2, [70000, 10], 65536, 2,
                                        device="cpu")


def test_make_mesh_cpu_virtual_shards():
    assert sharded.make_mesh(device="cpu").size == 1
    mesh = sharded.make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.axis_names == ("blocks",)
    assert set(mesh.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError):
        sharded.make_mesh(sharded.CPU_VIRTUAL_SHARDS + 1, device="cpu")
    assert sharded.make_mesh(devices=["cpu"] * 3).size == 3
    with pytest.raises(ValueError):
        sharded.make_mesh(4, devices=["cpu"] * 3)


def test_split_places_rows_as_the_jax_mesh():
    assert sharded.split(list(range(7)), 4) == [[0, 1], [2, 3], [4, 5], [6]]
    assert sharded.split(list(range(5)), 4) == [[0, 1], [2, 3], [4]]
    assert sharded.split(list(range(3)), 1) == [[0, 1, 2]]


def test_shard_failure_is_raised():
    def fail(blocks, device, bucket):
        if blocks[0] == BLOCKS[4]:
            raise RuntimeError("shard 2 failed")
        return [len(b) for b in blocks]

    with pytest.raises(RuntimeError, match="shard 2 failed"):
        sharded.sharded_block_call(BLOCKS, fail, 4, device="cpu")


def test_compress_sharded_matches_jax():
    """The exact parse (G = 0) of the full step, at 1 KiB blocks."""
    from aocl_compression_tpu.parallel import sharded as jsharded
    data = DATA[:8 * 1024 + 500]
    ref = jsharded.compress_sharded(data, 1024, jsharded.make_mesh(4))
    got = sharded.compress_sharded(data, 1024,
                                   sharded.make_mesh(3, device="cpu"))
    assert got == ref


def test_dryrun_multichip_cpu(capsys):
    dryrun.dryrun_multichip(4, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and all("OK" in line for line in lines)
    assert "lz4_compress_blocks_multi" in lines[2]


# --- parallel/distributed.py --------------------------------------------------

@pytest.mark.parametrize("hosts,chips", [(2, 4), (4, 2), (8, 1), (1, 8)])
def test_host_chip_mesh_shapes(hosts, chips):
    mesh = distributed.make_host_chip_mesh(hosts, chips, device="cpu")
    assert mesh.axis_names == ("hosts", "chips")
    assert mesh.shape == (hosts, chips) and len(mesh.devices) == 8


def test_host_chip_mesh_oversubscription_error():
    with pytest.raises(ValueError):
        distributed.make_host_chip_mesh(16, 4, device="cpu")
    with pytest.raises(ValueError):
        distributed.make_host_chip_mesh(2, 3, devices=["cpu"] * 5)


def _dist_blocks(flagged: bool = False):
    """16 blocks of 1 KiB; with `flagged`, block 5 is one the sort-emit
    encoder flags (a > 256-byte literal run closed by an exact 4-byte
    match)."""
    blocks = [DATA[i * 1024:(i + 1) * 1024] for i in range(16)]
    if not flagged:
        return blocks
    for seed in range(16):
        rng = np.random.default_rng(seed)
        blk = bytearray(rng.integers(0, 256, 1024, dtype=np.uint8).tobytes())
        blk[300:304] = blk[8:12]
        blk[304] = blk[12] ^ 0x5A
        if lz4_device.encode_blocks([bytes(blk)], 2, device="cpu")[2]:
            blocks[5] = bytes(blk)
            return blocks
    raise AssertionError("no flagged block")


def test_distributed_one_process_matches_jax():
    """Unflagged blocks: the JAX package's function fails on a flagged one
    (it writes into the read-only numpy view of its gathered sizes)."""
    from aocl_compression_tpu.parallel import distributed as jdist
    blocks = _dist_blocks()
    ref_chunks, (ref_sizes, ref_tails), ref_n = \
        jdist.compress_blocks_distributed(
            blocks, 1024, jdist.make_host_chip_mesh(2, 4), accel=2)
    stats = {}
    chunks, (sizes, tails), n = distributed.compress_blocks_distributed(
        blocks, 1024, distributed.make_host_chip_mesh(2, 4, device="cpu"),
        accel=2, stats=stats)
    assert (chunks, n) == (ref_chunks, ref_n)
    np.testing.assert_array_equal(sizes, ref_sizes)
    np.testing.assert_array_equal(tails, ref_tails)
    assert stats == dict(total_in=16 * 1024, total_out=int(sizes.sum()))


def test_distributed_reencodes_flagged_blocks_before_the_table():
    blocks = _dist_blocks(flagged=True)
    chunks, (sizes, tails), n = distributed.compress_blocks_distributed(
        blocks, 1024, distributed.make_host_chip_mesh(2, 2, device="cpu"),
        accel=2)
    bodies, ref_tails = tlz4._device_bodies(blocks, 2, "cpu")
    assert chunks == bodies and n == 16
    assert sizes.tolist() == [len(b) for b in bodies]
    assert tails.tolist() == ref_tails


_RANK = r"""
import hashlib, json, sys
from aocl_compression_tpu_torch.parallel import distributed
store, rank, blocks_hex = sys.argv[1], int(sys.argv[2]), sys.argv[3]
blocks = [bytes.fromhex(b) for b in blocks_hex.split(",")]
import torch.distributed as dist
distributed.init_distributed("file://" + store, 2, rank, device="cpu")
try:
    mesh = distributed.make_host_chip_mesh(chips=2, device="cpu")
    stats = {}
    mine = blocks[rank * 8:(rank + 1) * 8]
    chunks, (sizes, tails), n = distributed.compress_blocks_distributed(
        mine, 1024, mesh, accel=2, stats=stats)
finally:
    dist.destroy_process_group()
print(json.dumps(dict(shape=list(mesh.shape), sizes=sizes.tolist(),
                      tails=tails.tolist(), n=n, stats=stats,
                      chunks=[c.hex() for c in chunks])))
"""


def test_distributed_two_rank_gloo(tmp_path):
    """Two processes in one gloo group, 8 blocks each: both ranks' tables
    equal each other and the one-process result; each rank keeps its own
    chunks."""
    blocks = _dist_blocks(flagged=True)
    arg = ",".join(b.hex() for b in blocks)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(tmp_path / "store"), str(r), arg],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in (0, 1)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    chunks, (sizes, tails), n = distributed.compress_blocks_distributed(
        blocks, 1024, distributed.make_host_chip_mesh(2, 2, device="cpu"),
        accel=2)
    for r, o in enumerate(outs):
        assert o["shape"] == [2, 2] and o["n"] == n == 16
        assert o["sizes"] == sizes.tolist() and o["tails"] == tails.tolist()
        assert o["stats"] == dict(total_in=16 * 1024,
                                  total_out=int(sizes.sum()))
        assert [bytes.fromhex(c) for c in o["chunks"]] == \
            chunks[r * 8:(r + 1) * 8]


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_virtual_shards_on_one_card_equal_single_device(cuda_device):
    devices = [cuda_device] * 4
    compact.launches = 0
    got = sharded.compress_blocks_multi(BLOCKS, 2, device=cuda_device,
                                        devices=devices)
    assert compact.launches == 2 * 4
    assert got == tlz4._device_bodies(BLOCKS, 2, cuda_device)
    assert got == tlz4._device_bodies(BLOCKS, 2, "cpu")
    chunks, dlens = lz4_stitch.stitch_bodies(*got, BLOCKS)
    out = sharded.decompress_blocks_multi(chunks, dlens, BS,
                                          device=cuda_device, devices=devices)
    assert b"".join(out) == DATA
    assert out == lz4_device.decode_blocks(chunks, dlens, BS,
                                           device=cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["snappy", "zlib1", "zlib2", "zstd1"])
def test_codec_multi_on_one_card_equals_cpu(cuda_device, label):
    """4 virtual shards of one card against the single-device tier on the
    CPU."""
    multi, torch_tier = CODECS[label][2:4]
    got = _variant_call(multi, label, BLOCKS, cuda_device, num_shards=4,
                        devices=[cuda_device] * 4)
    assert got == _variant_call(torch_tier, label, BLOCKS, "cpu")
