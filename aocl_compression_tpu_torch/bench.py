"""`python -m aocl_compression_tpu_torch.bench` — the port's benchmark /
validation CLI (tools/bench_cli.py)."""

from .tools.bench_cli import main

if __name__ == "__main__":
    import sys
    sys.exit(main())
