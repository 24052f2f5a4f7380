"""Resilience soak: one transient failure mid-file, recovered from the
file's chunk checkpoint. The counterpart of
mini_parallel_tpu/tools/soak_resilience.py.

    python -m mini_parallel_tpu_torch.tools.soak_resilience CLEAN_CHECKPOINT \\
        [--lane L003] [--fail-at-chunk 60] [--allow-cpu]

Run it from a directory whose ``.env`` names the dataset (e.g. the lanes of
tools/make_scale_data), after a clean ``--full-wgs --mode kadane`` run over
the same lanes with the same chunk size: CLEAN_CHECKPOINT is that run's
checkpoint JSON. The soak runs ``--full-wgs``'s orchestrator in kadane mode
with ``retries=1``, its checkpoints under ``MPT_SOAK_CKPT_DIR`` (default
``./resil``; it must not hold an earlier soak's checkpoint, or every file
is skipped) and its benchmark row under ``MPT_RESULTS_DIR``.

The failure goes into the stream the ``--full-wgs`` path really reads,
``fastq.iter_flat_chunks`` as ``AlignmentEngine.self_align_file`` calls it:
the wrapper forwards every argument and raises once, at chunk
``--fail-at-chunk`` of the first file whose path holds ``--lane``. (The
JAX tool wraps ``fastq.iter_read_chunks``, which its ``--full-wgs`` path
never calls, so its injection never fires.) It passes, exit 0, only when
the injection fired exactly once, the failed file was retried once from a
chunk checkpoint past chunk 0, and every file's (reads, bases, score)
equals the clean run's. It prints one line per file and the JAX tool's JSON
line with ``injection_fired`` and ``retried_from_chunk``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time

from mini_parallel_tpu_torch.io import fastq


class Injection:
    """One transient failure in ``fastq.iter_flat_chunks`` at chunk
    ``chunk`` of the first stream whose path holds ``lane``."""

    def __init__(self, lane: str, chunk: int):
        self.lane, self.chunk = lane, chunk
        self.fired = 0

    @contextlib.contextmanager
    def installed(self):
        real = fastq.iter_flat_chunks

        def dying(path, *args, **kwargs):
            for i, chunk in enumerate(real(path, *args, **kwargs)):
                if not self.fired and self.lane in path and i == self.chunk:
                    self.fired += 1  # transient: the retry reads on
                    raise RuntimeError("injected transient failure (soak)")
                yield chunk

        fastq.iter_flat_chunks = dying
        try:
            yield self
        finally:
            fastq.iter_flat_chunks = real


def main(argv: list[str] | None = None, echo=print) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("clean_checkpoint",
                    help="the clean --full-wgs kadane run's checkpoint JSON")
    ap.add_argument("--lane", default="L003",
                    help="fail the first file whose path holds this tag")
    ap.add_argument("--fail-at-chunk", type=int, default=60,
                    help="the chunk of that file at which to fail once")
    ap.add_argument("--allow-cpu", action="store_true",
                    help="run on the CPU (the plain versions)")
    args = ap.parse_args(argv)

    from mini_parallel_tpu_torch.device import require_cuda
    from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
    from mini_parallel_tpu_torch.models.wgs import process_full_wgs_dataset
    from mini_parallel_tpu_torch.utils.config import get_config, load_dotenv

    load_dotenv()
    cfg = get_config()
    eng = AlignmentEngine(cfg, mode="kadane",
                          device=require_cuda("cpu" if args.allow_cpu else None))
    injection = Injection(args.lane, args.fail_at_chunk)
    lines: list[str] = []

    def log(line: str) -> None:
        lines.append(line)
        echo(line)

    t0 = time.perf_counter()
    # paths resolve from the invoker's working directory (its .env and the
    # checkpoint directory), never from the package directory
    with injection.installed():
        results = process_full_wgs_dataset(
            eng, cfg, checkpoint_dir=os.environ.get("MPT_SOAK_CKPT_DIR",
                                                    "./resil"),
            retries=1, results_dir=os.environ.get("MPT_RESULTS_DIR"),
            echo=log)
    wall = time.perf_counter() - t0

    with open(args.clean_checkpoint) as f:
        clean = {os.path.basename(c["file_path"]): c
                 for c in json.load(f)["files"]}
    ok = len(results) == len(clean)
    for r in results:
        name = os.path.basename(r.file_path)
        c = clean.get(name)
        same = c is not None and (r.total_reads, r.total_bases, r.score) == (
            c["total_reads"], c["total_bases"], c["score"])
        ok &= same
        echo(f"{name}: reads={r.total_reads} score={r.score} vs clean score="
             f"{c['score'] if c else None} {'OK' if same else 'MISMATCH'}")
    retries = [int(m.group(1)) for ln in lines
               if (m := re.search(r"attempt 1 failed .*; retrying from chunk "
                                  r"(\d+)", ln))]
    retried_from = retries[0] if len(retries) == 1 else None
    fired = injection.fired == 1
    echo(json.dumps({
        "metric": "soak_resilience",
        "injected": f"file {args.lane} chunk {args.fail_at_chunk} "
                    "(transient), retries=1",
        "bit_exact_vs_clean": bool(ok),
        "wall_seconds": round(wall, 1),
        "injection_fired": fired,
        "retried_from_chunk": retried_from,
    }))
    if not fired:
        echo("FAIL: the injection never fired: no failure was recovered")
    elif not retried_from:
        echo(f"FAIL: the failed file was not retried from a chunk checkpoint "
             f"(retries: {retries})")
    return 0 if ok and fired and retried_from else 1


if __name__ == "__main__":
    sys.exit(main())
