"""aocl_compression_tpu_torch — the PyTorch/CUDA port of aocl_compression_tpu.

The same unified API, handle, tier dispatch and RAP streams as the JAX
package, on torch tensors. Device tiers run on an NVIDIA GPU; hot stages
that were Pallas kernels are hand-written CUDA kernels
(aocl_compression_tpu_torch/csrc). All seven codecs run through the API:
lz4 and lz4hc (device encode and decode), snappy (device encode and
decode), zlib (device encode at levels 1 and 2, device inflate), zstd
(device encode at level 1, device decode), bzip2 (device block sort) and
lzma (device match-finder assist), each beside its host tier. The
multi-device tier (parallel/sharded.py, parallel/distributed.py) shards
the lz4, snappy, zlib and zstd encoders and the lz4 decoder over several
devices: setup(..., num_shards=n).

Quick start:

    import aocl_compression_tpu_torch as act
    h = act.setup("lz4", opt_var=2, block_size=65536)   # device="cuda"
    c = act.compress(h, data)
    d = act.decompress(h, c)
    act.destroy(h)

``setup(..., device="cpu")`` runs the device tiers' plain PyTorch versions
on the CPU.

Beside the API, as in the JAX package: CompressStream / DecompressStream
(streaming.py, host only), LZ4 frames (codecs/lz4_frame.py; a device
max_tier runs the device encoder), .xz (codecs/xz.py), the upstream-named
native API (native_api.py), zstd dictionary training
(codecs/zstd.train_dictionary), profiling hooks (utils/profiling.py) and
the bench CLI (``python -m aocl_compression_tpu_torch.bench``).
"""

from .api import (CompressionError, ErrorCode, Handle, Method,  # noqa: F401
                  Stats, compress, compress_bound, decompress, destroy,
                  get_codec, list_codecs, setup, version)
from .streaming import CompressStream, DecompressStream  # noqa: F401
from .utils.config import get_config, set_config  # noqa: F401

__version__ = "0.1.0"
