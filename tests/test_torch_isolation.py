"""The port imports neither jax nor anything of aocl_compression_tpu."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "aocl_compression_tpu_torch")

_BLOCKED_RUN = r"""
import sys
sys.modules["jax"] = None


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name == "aocl_compression_tpu" or name.startswith(
                "aocl_compression_tpu."):
            raise ImportError("blocked: " + name)
        return None


sys.meta_path.insert(0, Blocker())
import aocl_compression_tpu_torch as act
from aocl_compression_tpu_torch.ops import (bwt_device,  # noqa
                                            compact, deflate_device,
                                            entropy_scan, inflate_device,
                                            inflate_scan,
                                            lz4_device, lzma_assist,
                                            match_find, snappy_device,
                                            zstd_decode_device, zstd_device,
                                            zstd_scan)
from aocl_compression_tpu_torch.codecs import (snappy,  # noqa
                                               zlib_bzip2_lzma, zstd,
                                               zstd_format)
from aocl_compression_tpu_torch.parallel import container
from aocl_compression_tpu_torch.parallel import distributed, dryrun, sharded
from aocl_compression_tpu_torch.utils import calibration  # noqa
import zlib
data = (b"the block hash match stream " * 200)[:4000]
act.set_config(device_decode=True)
for method, kw in (("lz4", {}), ("snappy", {}), ("zlib", dict(level=1)),
                   ("zlib", dict(level=2)), ("zstd", dict(level=1))):
    h = act.setup(method, opt_var=2, block_size=1024, device="cpu", **kw)
    c = act.compress(h, data)
    assert act.decompress(h, c) == data
    if method == "zlib":
        assert zlib.decompress(container.skip_rap_frame(c)) == data
    if method == "zstd":
        from aocl_compression_tpu_torch.runtime import native
        assert native.zstd_decompress(c) == data
import bz2
import lzma
data = (data * 2)[:5000]   # over the bzip2 / lzma device threshold
for method in ("bzip2", "lzma"):
    h = act.setup(method, opt_var=2, device="cpu")
    c = act.compress(h, data)
    assert act.decompress(h, c) == data
    assert (bz2.decompress(c) if method == "bzip2"
            else lzma.decompress(c, format=lzma.FORMAT_ALONE)) == data
# the host surface and tools, each driven once on the CPU
import contextlib
import io
import tempfile
from aocl_compression_tpu_torch import bench, native_api, streaming  # noqa
from aocl_compression_tpu_torch.codecs import lz4_frame, xz
from aocl_compression_tpu_torch.tools import bench_cli
from aocl_compression_tpu_torch.utils import profiling
from aocl_compression_tpu_torch.utils.config import TIER_TORCH
f = lz4_frame.compress_frame(data, max_tier=TIER_TORCH, device="cpu")
assert lz4_frame.decompress_frame(f) == data
for codec in ("zlib", "gzip", "zstd", "bzip2", "lz4"):
    cs = streaming.CompressStream(codec)
    s = cs.write(data) + cs.finish()
    ds = act.DecompressStream(codec)
    assert ds.write(s) + ds.finish() == data
assert lzma.decompress(xz.xz_compress(data, 1)) == data
c = native_api.LZ4_compress_fast(data, 2, device="cpu")
assert native_api.LZ4_decompress_safe(c, len(data), device="cpu") == data
import numpy as np
words = [b"hash ", b"match ", b"the ", b"block ", b"stream "]
text = b"".join(words[i] for i in np.random.default_rng(0).integers(0, 5,
                                                                    5000))
d = zstd.train_dictionary([text[i:i + 500] for i in range(0, 15000, 250)],
                          2048)
part = text[15000:20000]
assert native_api.ZSTD_decompress_usingDict(native_api.ZSTD_compress_usingDict(
    part, d, device="cpu"), d, len(part), device="cpu") == part
with tempfile.TemporaryDirectory() as td:
    with profiling.trace(td), profiling.annotate("span"):
        native_api.LZ4_compress_default(data, device="cpu")
    path = td + "/sample.bin"
    with open(path, "wb") as fh:
        fh.write(data)
    with contextlib.redirect_stdout(io.StringIO()):
        assert bench.main(["-e", "lz4:0:2", "-t", "-i", "1", "--device",
                           "cpu", path]) == 0
assert bench.main is bench_cli.main
# the multi-device tier on virtual shards of the CPU
with contextlib.redirect_stdout(io.StringIO()):
    dryrun.dryrun_multichip(2, device="cpu")
assert sharded.compress_blocks_multi([data[:2500], data[2500:]], 2, 2,
                                     device="cpu")[1]
assert distributed.make_host_chip_mesh(2, 2, device="cpu").size == 4
assert not any(m == "jax" or m.startswith("aocl_compression_tpu.")
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, AOCL_ENABLE_INSTRUCTIONS="TORCH")
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_source_scan_no_jax_or_reference_imports():
    bad = []
    for path in _sources():
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "aocl_compression_tpu"):
                bad.append((os.path.relpath(path, ROOT), mod))
    assert bad == []
