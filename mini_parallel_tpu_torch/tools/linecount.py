"""Line counter for FASTQ(.gz) files — tools/linecount.rs parity. The
counterpart of mini_parallel_tpu/tools/linecount.py.

Usage: python -m mini_parallel_tpu_torch.tools.linecount FILE [FILE...]

Counts through io/fastq.count_lines, whose engine (the native C++ counter
when it builds, else Python's gzip) is resolved before the first file is
read; a file that cannot be read prints an ERROR line and exits 1. Nothing
falls back from the native counter to Python once chosen, so a broken
native build shows as a failure, not as a slower count.
"""

from __future__ import annotations

import sys

from mini_parallel_tpu_torch.io import fastq


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: linecount FILE [FILE...]", file=sys.stderr)
        return 2
    engine = fastq.resolved_engine("auto")
    rc = 0
    for path in argv:
        try:
            print(f"{path}: {fastq.count_lines(path, engine)} lines")
        except OSError as e:
            print(f"{path}: ERROR {e}", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
