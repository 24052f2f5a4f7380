"""CLI of the PyTorch/CUDA port: the counterpart of mini_parallel_tpu/cli.py.

The flag surface is the JAX package's (itself ``smith_waterman/src/main.rs:11-46``
plus its additions). Ported: ``--full-wgs``, ``--test-wgs``, direct
``-1/-2`` pairs of any length, ``--files`` pair mode, ``--complementarity``,
``--long-align``, ``--variant-prep`` (with ``--gapped``, ``--gap-model``,
``--rescue``, ``--min-base-quality``, ``--genotype``, ``--vcf-out``,
``--sam-out`` and ``--prep-checkpoint``) and ``--kmer`` (with ``-k``,
``--canonical``, ``--kmer-out`` and ``--kmer-checkpoint``), in every
``--mode`` (kadane, sw, sw-affine, contiguous), with ``--allow-cpu``,
``--env``, ``--chunk-size``, ``--retries`` and ``--profile DIR`` (a
``torch.profiler`` trace of the whole run in the TensorBoard/Chrome trace
layout, with the program's spans, the FASTQ decoder's thread among them,
and its counters). ``--full-wgs`` runs under the system monitors
(utils/perf_logger.py: ``logs/run_N/``) and attaches their summary to its
benchmark row. ``MPT_MESH_SHAPE`` (e.g. "4" or "1x4") shards every engine's
batches over a device mesh (parallel/mesh.py): every local card, or with
``--allow-cpu`` that many CPU shards; a mesh with a ``seq`` axis runs
``--long-align`` by row bands. With ``JAX_COORDINATOR_ADDRESS`` (and
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``, the JAX CLI's variables) the
process joins a gloo process group first, and ``--full-wgs`` splits the
files across the processes and prints the merged ``Global totals``
(parallel/distributed.py).

    python -m mini_parallel_tpu_torch --full-wgs --mode sw
    python -m mini_parallel_tpu_torch --files -1 R1.fastq.gz -2 R2.fastq.gz
    python -m mini_parallel_tpu_torch --complementarity -1 R1.fastq.gz -2 R2.fastq.gz
    python -m mini_parallel_tpu_torch --long-align -1 a.fa -2 b.fa --mode sw-affine
    python -m mini_parallel_tpu_torch --variant-prep L1.fastq.gz,L2.fastq.gz \
        --reference ref.fa --gapped --gap-model affine --genotype --vcf-out calls.vcf
    python -m mini_parallel_tpu_torch --kmer L1.fastq.gz,L2.fastq.gz -k 21 \
        --canonical --kmer-out counts.tsv
    python -m mini_parallel_tpu_torch --full-wgs --mode sw --profile traces/
    MPT_MESH_SHAPE=8 python -m mini_parallel_tpu_torch --full-wgs --allow-cpu
    JAX_COORDINATOR_ADDRESS=localhost:29500 JAX_NUM_PROCESSES=2 \
        JAX_PROCESS_ID=0 python -m mini_parallel_tpu_torch --full-wgs

A CUDA device is mandatory, as the reference's GPU was (main.rs:76-79),
unless ``--allow-cpu`` asks for the CPU explicitly.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import socket
import sys
import time

from mini_parallel_tpu_torch.utils import config as config_mod


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mini_parallel_tpu_torch",
        description="Sequence alignment and variant-call prep on CUDA "
        "GPUs: the PyTorch port of mini_parallel_tpu (--full-wgs, --test-wgs, "
        "--files, --complementarity, --long-align, --variant-prep, --kmer, "
        "direct pairs).",
    )
    p.add_argument("-1", "--seq1", help="first sequence (or file path with --files)")
    p.add_argument("-2", "--seq2", help="second sequence (or file path with --files)")
    p.add_argument("-f", "--files", action="store_true",
                   help="treat --seq1/--seq2 as FASTQ file paths")
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
                   "sw=true Smith-Waterman, sw-affine=affine gaps (Gotoh), "
                   "contiguous=exact contiguous Kadane")
    p.add_argument("--kmer", metavar="FASTQ[,FASTQ...]",
                   help="count k-mers exactly in the comma-separated lanes")
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
                   help="direct+complementary mate-pair analysis of -1/-2 "
                   "lane files (%% non-complementary metric)")
    p.add_argument("--variant-prep", metavar="FASTQ[,FASTQ...]",
                   help="map reads to --reference, build the pileup, emit "
                   "candidate variant sites; comma-separate lanes to process "
                   "a whole sample")
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
                   help="Pair-HMM diploid genotype likelihoods (GT/GQ/PL) "
                   "for the --variant-prep candidates")
    p.add_argument("--gt-window", type=int, default=50, metavar="W",
                   help="haplotype half-window for --genotype")
    p.add_argument("--gt-max-reads", type=int, default=64, metavar="N",
                   help="max reads per site for --genotype")
    p.add_argument("--prep-checkpoint", metavar="NPZ", default=None,
                   help="--variant-prep snapshot file")
    p.add_argument("--prep-checkpoint-every", type=int, default=200,
                   metavar="N", help="chunks between --prep-checkpoint snapshots")
    p.add_argument("--long-align", action="store_true",
                   help="exact SW of two LONG sequences (-1/-2 are FASTA "
                   "paths; --mode sw or sw-affine): the column-strip engine")
    p.add_argument("--retries", type=int, default=0, metavar="N",
                   help="--full-wgs: retry a failed file up to N times, "
                   "resuming from its last chunk checkpoint (0 = abort on "
                   "failure, the reference's semantics)")
    p.add_argument("--allow-cpu", action="store_true",
                   help="run on the CPU (the reference exits without a GPU; "
                   "main.rs:76-79)")
    p.add_argument("--env", default=".env", help="path to .env config file")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a torch.profiler trace of the run into DIR "
                   "(CPU, and CUDA on the card) with the program's spans, "
                   "the FASTQ decoder's thread among them, and its "
                   "counters; view with Perfetto, TensorBoard or "
                   "chrome://tracing")
    return p


@contextlib.contextmanager
def profiled(trace_dir: str, cuda: bool, echo=print):
    """A ``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity when ``cuda``), written into ``trace_dir`` as
    ``<host>_<pid>.<ns>.pt.trace.json``, the layout TensorBoard's
    profiler plugin and ``tensorboard_trace_handler`` use. The span
    recorder (utils/spans.py) runs for the block: the spans of the threads
    the profiler does not capture (the FASTQ decoder's) and the counters
    are appended to the trace, on its clock. The trace is stopped and
    written however the block ends; a failed write raises."""
    import torch

    from mini_parallel_tpu_torch.utils import spans

    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    spans.start()
    try:
        yield
    finally:
        rec = spans.stop()
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"{socket.gethostname()}_{os.getpid()}"
                            f".{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        if not os.path.isfile(path):
            raise OSError(f"the profiler wrote no trace to {path}")
        spans.append_to_chrome_trace(path, rec)
        echo(f"Profile trace written to {path}")


def main(argv: list[str] | None = None, echo=print) -> int:
    args = build_parser().parse_args(argv)
    config_mod.load_dotenv(args.env)  # main.rs:50
    from mini_parallel_tpu_torch.parallel.mesh import initialize_distributed

    try:  # a process of a multi-process run joins its group first
        initialize_distributed()
    except ValueError as e:
        echo(f"ERROR: {e}")
        return 1
    env = dict(os.environ)
    if args.chunk_size is not None:
        env["GPU_CHUNK_SIZE_READS"] = str(args.chunk_size)
    cfg = config_mod.get_config(
        env, require_chunk_size=args.full_wgs or args.test_wgs or args.files)
    if args.mode:
        cfg.mode = args.mode
    if not args.profile:
        return _dispatch(args, cfg, echo)
    import torch

    with profiled(args.profile,
                  not args.allow_cpu and torch.cuda.is_available(), echo):
        return _dispatch(args, cfg, echo)


def _dispatch(args, cfg, echo) -> int:
    """Run the mode the flags select."""
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

    if args.complementarity and not (args.full_wgs or args.variant_prep or (
            args.seq1 and args.seq2)):
        echo("ERROR: --complementarity requires -1 R1.fastq.gz -2 R2.fastq.gz")
        return 2
    if not (args.full_wgs or args.variant_prep or args.kmer
            or (args.seq1 and args.seq2)):
        if args.long_align:
            echo("ERROR: --long-align requires -1 a.fasta -2 b.fasta")
        elif args.files:
            echo("ERROR: --files requires --seq1 and --seq2 file paths")
        else:
            build_parser().print_help()
        return 2
    if args.long_align and args.mode and args.mode not in ("sw", "sw-affine"):
        echo("ERROR: --long-align supports --mode sw or sw-affine")
        return 2

    from mini_parallel_tpu_torch.device import NoAcceleratorError, require_cuda
    from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
    from mini_parallel_tpu_torch.utils.system_info import get_system_info

    try:
        device = require_cuda("cpu" if args.allow_cpu else None)
    except NoAcceleratorError as e:
        echo(f"ERROR: {e}")
        return 1  # GPU-mandatory behavior, main.rs:76-79,160-163
    mesh = None
    if cfg.mesh_shape:  # MPT_MESH_SHAPE: shard batches over local devices
        from mini_parallel_tpu_torch.parallel.mesh import make_mesh

        try:
            mesh = make_mesh(cfg.mesh_shape, devices=(
                [device] * math.prod(cfg.mesh_shape)
                if device.type == "cpu" else None))
        except ValueError as e:
            echo(f"ERROR: {e}")
            return 1
    engine = AlignmentEngine(cfg, device=device, mesh=mesh)
    echo(get_system_info(device).banner())

    if args.full_wgs:  # main.rs:72-124
        return _full_wgs(args, cfg, engine, echo)
    if args.variant_prep:
        return _variant_prep(args, cfg, device, mesh, echo)
    if args.complementarity:
        return _complementarity(args, cfg, device, mesh, echo)
    if args.kmer:
        return _kmer(args, cfg, device, mesh, echo)
    if args.long_align:
        return _long_align(args, cfg, device, mesh, echo)
    if args.files:  # main.rs:170-182
        try:
            res = engine.pair_align_files(args.seq1, args.seq2, progress=echo)
        except (OSError, IOError) as e:
            echo(f"ERROR: {e}")
            return 1
        echo(f"Loaded {res.bases1} bases from {args.seq1}")
        echo(f"Loaded {res.bases2} bases from {args.seq2}")
        echo(f"Alignment score: {res.score}")
        echo(f"Processing time: {res.processing_time_ms:.2f} ms on {res.device}")
        return 0
    score = engine.score_strings(args.seq1, args.seq2)  # main.rs:183-191
    echo(f"Alignment score: {score}")
    return 0


def _full_wgs(args, cfg, engine, echo) -> int:
    """--full-wgs under the system monitors; their summary goes onto the
    run's benchmark row (the reference read nvidia-smi dmon,
    perf_logger.rs:77-82, then wrote a fixed 25% into its results,
    benchmark.rs:159)."""
    from mini_parallel_tpu_torch.models.wgs import process_full_wgs_dataset
    from mini_parallel_tpu_torch.parallel.distributed import (
        process_full_wgs_distributed,
    )
    from mini_parallel_tpu_torch.utils.bench_tracker import annotate_run
    from mini_parallel_tpu_torch.utils.perf_logger import (
        summarize_monitor_logs,
        system_monitors,
    )

    bench_runs: list[int] = []
    on_bench = lambda b: bench_runs.append(b.run_number)  # noqa: E731
    with system_monitors(device=engine.device) as mon:
        if os.environ.get("JAX_COORDINATOR_ADDRESS"):
            results, merged = process_full_wgs_distributed(
                engine, cfg, echo=echo, retries=args.retries,
                on_bench=on_bench)
            echo(f"Global totals: {merged}")
        else:
            results = process_full_wgs_dataset(
                engine, cfg, echo=echo, retries=args.retries,
                on_bench=on_bench)
    summary = summarize_monitor_logs(mon.run_dir)
    if summary:
        echo(f"Monitor summary ({mon.run_dir}): {summary}")
        for rn in bench_runs:
            annotate_run(rn, {"monitor_summary": summary})
    echo(f"Processed {len(results)} files")
    return 0


def _variant_prep(args, cfg, device, mesh, echo) -> int:
    if not args.reference:
        echo("ERROR: --variant-prep requires --reference FASTA")
        return 2
    if args.sam_out and not args.gapped:
        echo("ERROR: --sam-out requires --gapped (SAM CIGARs come from "
             "the traceback)")
        return 2
    from mini_parallel_tpu_torch.io import fasta
    from mini_parallel_tpu_torch.models.variant_prep import (
        VariantPrepEngine,
        write_candidates_vcf,
    )

    try:
        recs = fasta.read_fasta(args.reference)
        if not recs:
            raise ValueError(f"no FASTA records in {args.reference}")
        # references always map through the contig table, so candidate and
        # VCF coordinates carry the real record names
        veng = VariantPrepEngine(recs, cfg, gapped=args.gapped,
                                 rescue=args.rescue,
                                 min_base_quality=args.min_base_quality,
                                 gap_model=args.gap_model, device=device,
                                 mesh=mesh)
        paths = args.variant_prep.split(",")
        res = veng.process_file(
            paths if len(paths) > 1 else paths[0], progress=echo,
            sam_out=args.sam_out, checkpoint_path=args.prep_checkpoint,
            checkpoint_every=args.prep_checkpoint_every)
        if args.genotype:
            res = veng.genotype_candidates(
                paths if len(paths) > 1 else paths[0], res,
                window=args.gt_window, max_reads_per_site=args.gt_max_reads,
                progress=echo)
    except (OSError, IOError, ValueError) as e:
        echo(f"ERROR: {e}")
        return 1
    echo(f"Reference length: {res.reference_length}")
    echo(f"Reads: {res.total_reads}, mapped: {res.mapped_reads} "
         f"({100*res.mapping_rate:.1f} %)")
    echo(f"Candidate variant sites: {len(res.candidates)}")
    for c in res.candidates[:10]:
        extra = f" GT={c.gt} GQ={c.gq}" if c.gt else ""
        echo(f"  {c.contig}:{c.pos+1}: {c.ref_base}->{c.alt_base} "
             f"depth={c.depth} alt={c.alt_count}{extra}")
    if args.vcf_out:
        write_candidates_vcf(args.vcf_out, res)
        echo(f"Candidates written to {args.vcf_out}")
    if args.sam_out:
        echo(f"SAM: {res.total_reads} records ({res.mapped_reads} "
             f"mapped) -> {args.sam_out}")
    return 0


def _complementarity(args, cfg, device, mesh, echo) -> int:
    from mini_parallel_tpu_torch.models.complementarity import (
        ComplementarityEngine,
    )

    ceng = ComplementarityEngine(cfg, mode=cfg.mode if args.mode else "sw",
                                 device=device, mesh=mesh)
    try:
        res = ceng.analyze_lane_pair(args.seq1, args.seq2, progress=echo)
    except (OSError, IOError) as e:
        echo(f"ERROR: {e}")
        return 1
    echo(f"Pairs: {res.pairs}")
    echo(f"Direct score sum: {res.direct_score_sum}")
    echo(f"Complementary score sum: {res.comp_score_sum}")
    echo(f"Perfectly complementary: {res.perfect_pairs}")
    echo(f"Non-complementary: {res.pct_non_complementary:.2f} %")
    echo(f"Time: {res.seconds:.2f} s")
    return 0


def _kmer(args, cfg, device, mesh, echo) -> int:
    from mini_parallel_tpu_torch.models.kmer_model import KmerEngine

    eng = KmerEngine(cfg, k=args.kmer_size, canonical=args.canonical,
                     device=device, mesh=mesh)
    try:
        paths = args.kmer.split(",")
        res = eng.count_file(
            paths if len(paths) > 1 else paths[0], progress=echo,
            checkpoint_path=args.kmer_checkpoint,
            checkpoint_every=args.kmer_checkpoint_every,
            # the full table is drained only when something consumes it:
            # the dump or the checkpoints' host folds
            result_mode=("full" if args.kmer_out or args.kmer_checkpoint
                         else "summary"),
        )
    except (OSError, IOError, ValueError) as e:
        echo(f"ERROR: {e}")
        return 1
    echo(f"Total {res.k}-mers: {res.total_kmers}")
    echo(f"Distinct {res.k}-mers: {res.distinct_kmers}")
    echo(f"Reads: {res.total_reads}, time: {res.seconds:.2f} s")
    for s, c in res.top(10):
        echo(f"  {s}  {c}")
    if args.kmer_out:
        n = res.write_counts(args.kmer_out)
        echo(f"Counts: {n} records -> {args.kmer_out}")
    return 0


def _long_align(args, cfg, device, mesh, echo) -> int:
    from mini_parallel_tpu_torch.io import fasta
    from mini_parallel_tpu_torch.ops import sw_long
    from mini_parallel_tpu_torch.parallel.mesh import SEQ_AXIS

    # cfg.mode already reflects --mode or the env's MPT_MODE; modes without
    # a long-pair engine (kadane/contiguous defaults) fall back to true SW
    mode = cfg.mode if cfg.mode in ("sw", "sw-affine") else "sw"
    try:
        sa = fasta.read_first_sequence(args.seq1)
        sb = fasta.read_first_sequence(args.seq2)
    except (OSError, IOError, ValueError) as e:
        echo(f"ERROR: {e}")
        return 1
    echo(f"Sequences: {len(sa)} x {len(sb)} bases "
         f"({len(sa) * len(sb) / 1e9:.2f} Gcells, {mode})")
    t0 = time.perf_counter()
    # rows run along the longer side (fewer, fuller strips)
    a, b = (sa, sb) if len(sa) >= len(sb) else (sb, sa)
    gaps = {} if mode == "sw" else dict(gap_open=cfg.gap_open,
                                        gap_extend=cfg.gap_extend)
    try:
        if mesh is not None and SEQ_AXIS in mesh.axis_names:
            fn = (sw_long.sw_score_long_sharded if mode == "sw"
                  else sw_long.sw_affine_score_long_sharded)
            score = fn(a, b, mesh, progress=echo, **gaps)
        else:
            fn = (sw_long.sw_score_long if mode == "sw"
                  else sw_long.sw_affine_score_long)
            score = fn(a, b, device, progress=echo, **gaps)
    except ValueError as e:  # e.g. more row bands than rows on a seq mesh
        echo(f"ERROR: {e}")
        return 1
    dt = time.perf_counter() - t0
    echo(f"Alignment score: {score}")
    echo(f"Processing time: {dt:.2f} s "
         f"({len(sa) * len(sb) / max(dt, 1e-9) / 1e9:.1f} GCUPS)")
    return 0


def entrypoint() -> None:
    """console_scripts hook."""
    sys.exit(main())


if __name__ == "__main__":
    entrypoint()
