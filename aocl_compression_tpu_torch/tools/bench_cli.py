"""Benchmark / validation CLI of the port — the JAX package's
tools/bench_cli.py (parity with the reference's aocl_compression_bench),
with the device the port's tiers run on.

Usage:
  python -m aocl_compression_tpu_torch.bench [options] FILE [FILE...]

Options (reference-compatible where sensible):
  -a                 run all codecs x all levels (default without -e)
  -e M[:LVL[:OPT]]   one method (name or enum index), optional level/optVar
  -t                 verify: decompress and memcmp against the input
  -p                 print performance stats (speed MB/s, ratio)
  -i N               timed iterations, best-of-N (default 10)
  -o                 optOff: force the host reference tier
  -r MODE            run only "compress" or "decompress"
  -d FILE            dump the (last) compressed stream to FILE
  -n                 drive the native APIs instead of the unified API
  -m MB              use at most MB megabytes of each input
  -b BYTES           RAP block size (0 disables the RAP container)
  --json             emit one JSON line per run instead of a table
  --device DEV       where the device tiers run (default cuda; "cpu" runs
                     their plain PyTorch versions); passed to setup and to
                     the native APIs

The CLI reads only the files it is given. Times are host-clock seconds
around calls that end in a device-to-host copy, so they cover the device
work.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from .. import native_api
from ..api import unified
from ..api.registry import Method, get_codec

CODEC_ORDER = [m.name.lower() for m in Method]

_LEVELS = {  # default per-codec level sweeps, codec_bench style
    "lz4": [0], "lz4hc": [1, 4, 9, 12], "snappy": [0],
    "zlib": [1, 6, 9], "zstd": [1, 3, 9, 19], "bzip2": [1, 9],
    "lzma": [1, 6, 9],
}


def _parse_method(spec: str):
    parts = spec.split(":")
    name = parts[0]
    if name.isdigit():
        name = CODEC_ORDER[int(name)]
    level = int(parts[1]) if len(parts) > 1 and parts[1] else None
    opt_var = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return name, level, opt_var


def _native_roundtrip(name: str, level: Optional[int], data: bytes, device):
    n, d = len(data), device
    if name == "lz4":
        c = native_api.LZ4_compress_default(data, device=d)
        return c, lambda: native_api.LZ4_decompress_safe(c, n, device=d)
    if name == "lz4hc":
        c = native_api.LZ4_compress_HC(data, level or 9, device=d)
        return c, lambda: native_api.LZ4_decompress_safe(c, n, device=d)
    if name == "snappy":
        c = native_api.snappy_compress(data, device=d)
        return c, lambda: native_api.snappy_uncompress(c, device=d)
    if name == "zlib":
        c = native_api.compress2(data, level or 6, device=d)
        return c, lambda: native_api.uncompress(c, n, device=d)
    if name == "bzip2":
        c = native_api.BZ2_bzBuffToBuffCompress(data, level or 9, device=d)
        return c, lambda: native_api.BZ2_bzBuffToBuffDecompress(c, n,
                                                                device=d)
    if name == "lzma":
        c = native_api.LzmaEncode(data, level or 6, device=d)
        return c, lambda: native_api.LzmaDecode(c, n, device=d)
    if name == "zstd":
        c = native_api.ZSTD_compress(data, level or 3, device=d)
        return c, lambda: native_api.ZSTD_decompress(c, n, device=d)
    raise ValueError(name)


def run_one(name: str, level: Optional[int], opt_var: int, data: bytes,
            args) -> dict:
    rec = {"method": name, "level": level if level is not None else 0,
           "in_bytes": len(data)}
    iters = max(1, args.i)

    if args.n:
        best_c = best_d = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            c, dec = _native_roundtrip(name, level, data, args.device)
            best_c = min(best_c, time.perf_counter() - t0)
        if args.r in (None, "decompress"):
            for _ in range(iters):
                t0 = time.perf_counter()
                out = dec()
                best_d = min(best_d, time.perf_counter() - t0)
            if args.t and out != data:
                rec["verify"] = "FAIL"
                return rec
        rec.update(c_bytes=len(c),
                   ratio=round(len(data) / max(1, len(c)), 3),
                   c_speed_mbps=round(len(data) / best_c / 1e6, 1))
        if best_d < float("inf"):
            rec["d_speed_mbps"] = round(len(data) / best_d / 1e6, 1)
        if args.t:
            rec["verify"] = "OK"
        return rec

    kw = {"measure_stats": True, "opt_off": args.o}
    if level is not None:
        kw["level"] = level
    if opt_var:
        kw["opt_var"] = opt_var
    if args.b is not None:
        if args.b == 0:
            kw["enable_rap"] = False
        else:
            kw["block_size"] = args.b
    h = unified.setup(name, device=args.device, **kw)
    try:
        c = b""
        best_c = best_d = float("inf")
        if args.r in (None, "compress"):
            for _ in range(iters):
                t0 = time.perf_counter()
                c = unified.compress(h, data)
                best_c = min(best_c, time.perf_counter() - t0)
            rec.update(c_bytes=len(c),
                       ratio=round(len(data) / max(1, len(c)), 3),
                       c_speed_mbps=round(len(data) / best_c / 1e6, 1))
        if args.r in (None, "decompress") and c:
            out = b""
            for _ in range(iters):
                t0 = time.perf_counter()
                out = unified.decompress(h, c, expected_size=len(data))
                best_d = min(best_d, time.perf_counter() - t0)
            rec["d_speed_mbps"] = round(len(data) / best_d / 1e6, 1)
            if args.t:
                rec["verify"] = "OK" if out == data else "FAIL"
        if args.d and c:
            with open(args.d, "wb") as f:
                f.write(c)
    finally:
        unified.destroy(h)
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="aocl_compression_bench",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-a", action="store_true", help="all codecs")
    ap.add_argument("-e", metavar="M[:LVL[:OPT]]", help="single method")
    ap.add_argument("-t", action="store_true", help="verify roundtrip")
    ap.add_argument("-p", action="store_true", help="print perf stats")
    ap.add_argument("-i", type=int, default=10, metavar="N",
                    help="iterations (best-of-N)")
    ap.add_argument("-o", action="store_true", help="optOff (host tier)")
    ap.add_argument("-r", choices=["compress", "decompress"], default=None)
    ap.add_argument("-d", metavar="FILE", help="dump compressed stream")
    ap.add_argument("-n", action="store_true", help="native API mode")
    ap.add_argument("-m", type=int, default=0, metavar="MB",
                    help="max input megabytes")
    ap.add_argument("-b", type=int, default=None, metavar="BYTES",
                    help="RAP block size (0 = no container)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the device tiers run (default cuda)")
    ap.add_argument("files", nargs="+")
    args = ap.parse_args(argv)

    if args.e:
        name, level, opt_var = _parse_method(args.e)
        plan = [(name, level, opt_var)]
    else:
        plan = [(m, lv, 0) for m in CODEC_ORDER for lv in _LEVELS[m]]

    failures = 0
    for path in args.files:
        with open(path, "rb") as f:
            data = f.read(args.m * (1 << 20)) if args.m else f.read()
        for name, level, opt_var in plan:
            get_codec(name)  # validates
            rec = run_one(name, level, opt_var, data, args)
            rec["file"] = path
            if rec.get("verify") == "FAIL":
                failures += 1
            if args.json:
                print(json.dumps(rec))
            else:
                bits = [f"{rec['method']:6s} L{rec['level']:<2d}",
                        f"{rec['in_bytes']:>10d} -> "
                        f"{rec.get('c_bytes', 0):>10d}",
                        f"ratio {rec.get('ratio', 0):>7.3f}"]
                if args.p:
                    bits.append(f"c {rec.get('c_speed_mbps', 0):>8.1f} MB/s")
                    if "d_speed_mbps" in rec:
                        bits.append(f"d {rec['d_speed_mbps']:>8.1f} MB/s")
                if args.t:
                    bits.append(rec.get("verify", "-"))
                bits.append(path)
                print("  ".join(bits))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
