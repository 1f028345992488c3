"""The port's tools: the bench CLI (its --json sizes against the JAX
package's CLI on the same file), the profiling hooks, and, where a card is
present, the LZ4 frame and LZ4_compress_fast at the device tier on cuda
against the same calls on the CPU.

The JAX package is imported inside the tests that use it, so the card-only
tests also run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_tools.py
"""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from aocl_compression_tpu_torch import bench, native_api
from aocl_compression_tpu_torch.codecs import lz4_frame
from aocl_compression_tpu_torch.tools import bench_cli
from aocl_compression_tpu_torch.utils import profiling
from aocl_compression_tpu_torch.utils.config import TIER_TORCH


def _text(n: int, seed: int = 4) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"bench ", b"of ", b"hash ", b"match ", b"block ", b"window "]
    return b"".join(words[i] for i in rng.integers(0, len(words), n))[:n]


@pytest.fixture()
def sample(tmp_path):
    p = tmp_path / "sample.bin"
    p.write_bytes(_text(24_000))
    return str(p)


def _json_runs(main, argv, capsys):
    assert main(argv) == 0
    return [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]


def _sizes(recs):
    return [(r["method"], r["level"], r["in_bytes"], r["c_bytes"],
             r.get("verify")) for r in recs]


@pytest.mark.parametrize("mode", [["-a"], ["-n", "-a"]])
def test_cli_sizes_match_jax(sample, capsys, mode):
    """Every codec and level of the sweep (unified and native API) gives the
    JAX CLI's compressed sizes, each run verified."""
    from aocl_compression_tpu.tools import bench_cli as jcli
    argv = mode + ["-t", "-i", "1", "--json", sample]
    got = _json_runs(bench_cli.main, argv + ["--device", "cpu"], capsys)
    want = _json_runs(jcli.main, argv, capsys)
    assert _sizes(got) == _sizes(want)
    assert {r["method"] for r in got} == {"lz4", "lz4hc", "lzma", "bzip2",
                                          "snappy", "zlib", "zstd"}
    assert all(r["verify"] == "OK" for r in got)


class _Clock:
    """A perf_counter that advances a fixed step a call."""

    def __init__(self, step: float):
        self.t, self.step = 0.0, step

    def perf_counter(self) -> float:
        self.t += self.step
        return self.t


def test_cli_device_run_matches_jax(sample, capsys, monkeypatch, tmp_path):
    """-e lz4:0:2 runs the device tier (here on the CPU) with the JAX
    package's sizes at its device tier; -d dumps the stream. The CLI's
    clock advances 10 ms a reading, so each timed call takes 10 ms and the
    speeds are the sample's 24,000 B over 10 ms, whatever the load."""
    from aocl_compression_tpu.tools import bench_cli as jcli
    monkeypatch.setenv("AOCL_ENABLE_INSTRUCTIONS", "XLA")
    monkeypatch.setattr(bench_cli, "time", _Clock(0.01))
    dump = str(tmp_path / "dump.lz4")
    argv = ["-e", "lz4:0:2", "-b", "4096", "-t", "-p", "-i", "1", "--json"]
    got = _json_runs(bench_cli.main,
                     argv + ["--device", "cpu", "-d", dump, sample], capsys)
    want = _json_runs(jcli.main, argv + [sample], capsys)
    assert _sizes(got) == _sizes(want)
    assert got[0]["verify"] == "OK"
    assert got[0]["c_speed_mbps"] == got[0]["d_speed_mbps"] == 2.4
    assert os.path.getsize(dump) == got[0]["c_bytes"]


def test_cli_default_device_is_cuda(sample):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_cli.main(["-e", "lz4", "-i", "1", sample])


def test_bench_module_runs_the_cli():
    assert bench.main is bench_cli.main


def test_stopwatch():
    sw = profiling.Stopwatch()
    for dt in (0.02, 0.001):
        with sw.section("a"):
            time.sleep(dt)
    with sw.section("b"):
        pass
    assert sw.counts == {"a": 2, "b": 1}
    assert 0.001 <= sw.best["a"] < 0.02 <= sw.totals["a"]
    lines = sw.report().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["a", "b"]
    assert "(n=2)" in lines[0]


def _trace_names(log_dir):
    (path,) = glob.glob(os.path.join(log_dir, "*.json"))
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_holds_the_span(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("atpu-span"):
            native_api.LZ4_compress_fast(_text(5000), 1, device="cpu")
    assert "atpu-span" in _trace_names(str(tmp_path))


# --- card-only ---------------------------------------------------------------

@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # no tier cap: a TORCH cap would run the plain compaction
    monkeypatch.delenv("AOCL_ENABLE_INSTRUCTIONS", raising=False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("block_checksum", [False, True])
def test_frame_on_card_matches_cpu(cuda_device, block_checksum):
    from aocl_compression_tpu_torch.ops import compact
    data = _text(3 * 65536 + 5000, 6)
    n0 = compact.launches
    got = lz4_frame.compress_frame(data, block_checksum=block_checksum,
                                   max_tier=TIER_TORCH, device=cuda_device)
    assert compact.launches == n0 + 2 * 4   # one compact_rows a block
    assert got == lz4_frame.compress_frame(
        data, block_checksum=block_checksum, max_tier=TIER_TORCH,
        device="cpu")
    assert lz4_frame.decompress_frame(got) == data


@pytest.mark.cuda
def test_lz4_compress_fast_on_card_matches_cpu(cuda_device):
    data = _text(4 * 65536 + 123, 7)
    got = native_api.LZ4_compress_fast(data, 2, device=cuda_device)
    assert got == native_api.LZ4_compress_fast(data, 2, device="cpu")
    assert native_api.LZ4_decompress_safe(got, len(data),
                                          device=cuda_device) == data
