"""CLI of the PyTorch/CUDA port: the counterpart of mini_parallel_tpu/cli.py.

The flag surface is the JAX package's (itself ``smith_waterman/src/main.rs:11-46``
plus its additions). Ported: ``--full-wgs``, ``--test-wgs`` and direct
``-1/-2`` pairs, in ``--mode kadane`` or ``sw``, with ``--allow-cpu``,
``--env``, ``--chunk-size`` and ``--retries``. Every other mode flag is
accepted and exits 2 with "not yet ported".

    python -m mini_parallel_tpu_torch --full-wgs --mode sw

A CUDA device is mandatory, as the reference's GPU was (main.rs:76-79),
unless ``--allow-cpu`` asks for the CPU explicitly.
"""

from __future__ import annotations

import argparse
import os
import sys

from mini_parallel_tpu_torch.utils import config as config_mod

# mode flags of the JAX package that this package does not run yet
_NOT_PORTED = (
    ("files", "--files"),
    ("kmer", "--kmer"),
    ("complementarity", "--complementarity"),
    ("variant_prep", "--variant-prep"),
    ("long_align", "--long-align"),
    ("profile", "--profile"),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mini_parallel_tpu_torch",
        description="Sequence alignment on one CUDA GPU: the PyTorch port "
        "of mini_parallel_tpu (--full-wgs, --test-wgs, direct pairs).",
    )
    p.add_argument("-1", "--seq1", help="first sequence (or file path with --files)")
    p.add_argument("-2", "--seq2", help="second sequence (or file path with --files)")
    p.add_argument("-f", "--files", action="store_true",
                   help="treat --seq1/--seq2 as FASTQ file paths (not yet ported)")
    p.add_argument("-c", "--chunk-size", type=int, default=None,
                   help="reads per chunk (overrides GPU_CHUNK_SIZE_READS)")
    p.add_argument("-g", "--gpu", action="store_true",
                   help="compatibility flag; the GPU is always used")
    p.add_argument("-n", "--num-files", type=int, default=None,
                   help="compatibility flag (unused, matches reference)")
    p.add_argument("-t", "--test-wgs", action="store_true",
                   help="smoke-test WGS file reading (first lane pair)")
    p.add_argument("--full-wgs", action="store_true",
                   help="process the full WGS dataset with checkpoint/resume")
    p.add_argument("--mode", choices=("kadane", "sw", "sw-affine", "contiguous"),
                   default=None,
                   help="scoring mode: kadane=reference parity (default), "
                   "sw=true Smith-Waterman; sw-affine and contiguous are not "
                   "yet ported")
    p.add_argument("--kmer", metavar="FASTQ[,FASTQ...]",
                   help="count k-mers (not yet ported)")
    p.add_argument("-k", "--kmer-size", type=int, default=21,
                   help="k for --kmer (default 21)")
    p.add_argument("--canonical", action="store_true",
                   help="fold k-mers with their reverse complements")
    p.add_argument("--kmer-out", metavar="PATH", default=None,
                   help="k-mer counts output (with --kmer)")
    p.add_argument("--kmer-checkpoint", metavar="NPZ", default=None,
                   help="--kmer snapshot file")
    p.add_argument("--kmer-checkpoint-every", type=int, default=200,
                   metavar="N", help="chunks between --kmer-checkpoint snapshots")
    p.add_argument("--complementarity", action="store_true",
                   help="mate-pair complementarity (not yet ported)")
    p.add_argument("--variant-prep", metavar="FASTQ[,FASTQ...]",
                   help="variant-call prep (not yet ported)")
    p.add_argument("--reference", metavar="FASTA",
                   help="reference FASTA(.gz) for --variant-prep")
    p.add_argument("--vcf-out", metavar="PATH", default=None,
                   help="VCF output (with --variant-prep)")
    p.add_argument("--sam-out", metavar="PATH", default=None,
                   help="SAM output (with --variant-prep)")
    p.add_argument("--gapped", action="store_true",
                   help="gapped pileup for --variant-prep")
    p.add_argument("--gap-model", choices=("linear", "affine"),
                   default="linear", help="gap scoring for --gapped")
    p.add_argument("--min-base-quality", type=int, default=0,
                   help="base-quality floor for --variant-prep")
    p.add_argument("--rescue", action="store_true",
                   help="SW rescue for --variant-prep")
    p.add_argument("--genotype", action="store_true",
                   help="Pair-HMM genotyping for --variant-prep")
    p.add_argument("--gt-window", type=int, default=50, metavar="W",
                   help="haplotype half-window for --genotype")
    p.add_argument("--gt-max-reads", type=int, default=64, metavar="N",
                   help="max reads per site for --genotype")
    p.add_argument("--prep-checkpoint", metavar="NPZ", default=None,
                   help="--variant-prep snapshot file")
    p.add_argument("--prep-checkpoint-every", type=int, default=200,
                   metavar="N", help="chunks between --prep-checkpoint snapshots")
    p.add_argument("--long-align", action="store_true",
                   help="exact SW of two long sequences (not yet ported)")
    p.add_argument("--retries", type=int, default=0, metavar="N",
                   help="--full-wgs: retry a failed file up to N times, "
                   "resuming from its last chunk checkpoint (0 = abort on "
                   "failure, the reference's semantics)")
    p.add_argument("--allow-cpu", action="store_true",
                   help="run on the CPU (the reference exits without a GPU; "
                   "main.rs:76-79)")
    p.add_argument("--env", default=".env", help="path to .env config file")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="profiler trace (not yet ported)")
    return p


def main(argv: list[str] | None = None, echo=print) -> int:
    args = build_parser().parse_args(argv)
    for attr, flag in _NOT_PORTED:
        if getattr(args, attr):
            echo(f"ERROR: {flag} is not yet ported to mini_parallel_tpu_torch "
                 "(the JAX package, python -m mini_parallel_tpu, runs it)")
            return 2
    config_mod.load_dotenv(args.env)  # main.rs:50
    env = dict(os.environ)
    if args.chunk_size is not None:
        env["GPU_CHUNK_SIZE_READS"] = str(args.chunk_size)
    cfg = config_mod.get_config(
        env, require_chunk_size=args.full_wgs or args.test_wgs)
    if args.mode:
        cfg.mode = args.mode

    if args.test_wgs:  # main.rs:127-153: counts bases, needs no device
        from mini_parallel_tpu_torch.io import fastq

        ok = True
        for read in (1, 2):
            name = f"{cfg.sample_id}_L001_R{read}_001.fastq.gz"
            path = os.path.join(cfg.wgs_data_dir, name)
            try:
                bases = fastq.count_bases(path, cfg.chunk_size_reads)
                echo(f"[ok] {name}: {bases} bases")
            except (OSError, IOError) as e:
                echo(f"[fail] {name}: {e}")
                ok = False
        return 0 if ok else 1

    if not (args.full_wgs or (args.seq1 and args.seq2)):
        build_parser().print_help()
        return 2

    from mini_parallel_tpu_torch.device import NoAcceleratorError, require_cuda
    from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
    from mini_parallel_tpu_torch.utils.system_info import get_system_info

    try:
        device = require_cuda("cpu" if args.allow_cpu else None)
    except NoAcceleratorError as e:
        echo(f"ERROR: {e}")
        return 1  # GPU-mandatory behavior, main.rs:76-79,160-163
    try:
        engine = AlignmentEngine(cfg, device=device)
    except NotImplementedError as e:
        echo(f"ERROR: {e}")
        return 2
    echo(get_system_info(device).banner())

    if args.full_wgs:  # main.rs:72-124
        from mini_parallel_tpu_torch.models.wgs import process_full_wgs_dataset

        results = process_full_wgs_dataset(engine, cfg, echo=echo,
                                           retries=args.retries)
        echo(f"Processed {len(results)} files")
        return 0

    try:  # main.rs:183-191
        score = engine.score_strings(args.seq1, args.seq2)
    except NotImplementedError as e:
        echo(f"ERROR: {e}")
        return 2
    echo(f"Alignment score: {score}")
    return 0


def entrypoint() -> None:
    """console_scripts hook."""
    sys.exit(main())


if __name__ == "__main__":
    entrypoint()
