"""Count lines from stdin — tools/stdin_linecount.rs parity. The
counterpart of mini_parallel_tpu/tools/stdin_linecount.py.

Usage: zcat file.fastq.gz | python -m mini_parallel_tpu_torch.tools.stdin_linecount

Prints the count; a progress line goes to stderr every 10,000,000 lines.
"""

from __future__ import annotations

import sys

PROGRESS_EVERY = 10_000_000  # stdin_linecount.rs progress cadence


def main(stream=None) -> int:
    stream = sys.stdin.buffer if stream is None else stream
    n = 0
    for _ in stream:
        n += 1
        if n % PROGRESS_EVERY == 0:
            print(f"... {n} lines", file=sys.stderr)
    print(n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
