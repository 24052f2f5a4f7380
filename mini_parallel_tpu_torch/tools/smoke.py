"""End-to-end CLI smoke: every mode driven against generated fixtures. The
counterpart of mini_parallel_tpu/tools/smoke.py.

    python -m mini_parallel_tpu_torch.tools.smoke [--keep] [--chunk 40] [--allow-cpu]

One command, every mode of the port's ``cli.main``, fresh seeded fixtures
(the JAX tool's, byte for byte) in a temporary directory: the kernel gate
(tools/kernel_check) first, then 12 modes, PASS/FAIL per row, exit 1 on any
failure. On the card every mode runs on it; ``--allow-cpu`` appends
``--allow-cpu`` to every mode and runs the gate's plain rows instead.
"""

from __future__ import annotations

import argparse
import gzip
import os
import random
import shutil
import tempfile

# the fixtures' dataset, forced so that an inherited WGS_* can never point
# --full-wgs/--test-wgs at a real (multi-GB) dataset
SMOKE_ENV = {"WGS_SAMPLE_ID": "SMK", "WGS_LANES": "2",
             "WGS_READS_PER_LANE": "2"}


def _fixtures(tmp: str):
    random.seed(20260816)
    ref = bytes(random.choice(b"ACGT") for _ in range(3000))
    snp = 1500
    alt = b"A" if ref[snp:snp + 1] != b"A" else b"C"
    hap = ref[:snp] + alt + ref[snp + 1:]
    rc = bytes.maketrans(b"ACGT", b"TGCA")

    def write_fq(name, reads):
        path = os.path.join(tmp, name)
        with gzip.open(path, "wt", compresslevel=1) as f:
            for i, r in enumerate(reads):
                f.write(f"@r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")
        return path

    mapped = [hap[s:s + 80] for s in
              (random.randrange(0, 2900) for _ in range(120))]
    r1 = [ref[i * 20:i * 20 + 60] for i in range(40)]
    r2 = [r.translate(rc)[::-1] for r in r1]
    with gzip.open(os.path.join(tmp, "ref.fa.gz"), "wt") as f:
        f.write(">chrS\n")
        for i in range(0, len(ref), 70):
            f.write(ref[i:i + 70].decode() + "\n")
    for lane in (1, 2):
        for r in (1, 2):  # test-wgs reads the first lane PAIR (R1 + R2)
            write_fq(f"SMK_L{lane:03d}_R{r}_001.fastq.gz", mapped[:60])
    # long-align FASTA pair (> LONG_PAIR_THRESHOLD -> column-strip engine)
    la = bytes(random.choice(b"ACGT") for _ in range(6000))
    lb = la[500:5500] + bytes(random.choice(b"ACGT") for _ in range(800))
    for name, seq in (("la_a.fa", la), ("la_b.fa", lb)):
        with open(os.path.join(tmp, name), "w") as f:
            f.write(">s\n" + seq.decode() + "\n")
    return {
        "la_a": os.path.join(tmp, "la_a.fa"),
        "la_b": os.path.join(tmp, "la_b.fa"),
        "ref_fa": os.path.join(tmp, "ref.fa.gz"),
        "reads": write_fq("reads.fastq.gz", mapped),
        "r1": write_fq("r1.fastq.gz", r1),
        "r2": write_fq("r2.fastq.gz", r2),
    }


def modes(fx: dict) -> list[tuple[str, list[str]]]:
    """The 12 CLI invocations of the JAX tool, by name."""
    return [
        ("direct", ["-1", "ACGTACGT", "-2", "ACGAACGT"]),
        ("direct-sw", ["-1", "ACGTACGT", "-2", "ACGAACGT", "--mode", "sw"]),
        ("test-wgs", ["--test-wgs"]),
        ("full-wgs", ["--full-wgs", "--retries", "1"]),
        ("pair-files", ["--files", "-1", fx["r1"], "-2", fx["r2"]]),
        ("kmer", ["--kmer", fx["reads"], "-k", "21",
                  "--kmer-out", "k.tsv.gz"]),
        ("kmer-multi", ["--kmer", f"{fx['r1']},{fx['r2']}", "-k", "15"]),
        ("complementarity", ["--complementarity", "-1", fx["r1"],
                             "-2", fx["r2"]]),
        ("variant-prep", ["--variant-prep", fx["reads"],
                          "--reference", fx["ref_fa"], "--vcf-out", "v.vcf"]),
        ("variant-gapped-affine", ["--variant-prep", fx["reads"],
                                   "--reference", fx["ref_fa"], "--gapped",
                                   "--gap-model", "affine",
                                   "--sam-out", "o.sam"]),
        ("genotype", ["--variant-prep", fx["reads"], "--reference",
                      fx["ref_fa"], "--genotype", "--vcf-out", "g.vcf"]),
        ("long-align", ["--long-align", "-1", fx["la_a"], "-2", fx["la_b"],
                        "--mode", "sw"]),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keep", action="store_true",
                    help="keep the fixture dir (prints its path)")
    ap.add_argument("--chunk", type=int, default=40)
    ap.add_argument("--allow-cpu", action="store_true",
                    help="append --allow-cpu to every mode (no card)")
    args = ap.parse_args(argv)

    from mini_parallel_tpu_torch.cli import main as cli_main
    from mini_parallel_tpu_torch.tools import kernel_check

    tmp = tempfile.mkdtemp(prefix="mptt_smoke_")
    fx = _fixtures(tmp)
    env = dict(SMOKE_ENV, GPU_CHUNK_SIZE_READS=str(args.chunk),
               WGS_DATA_DIR=tmp)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    cwd = os.getcwd()
    os.chdir(tmp)
    rows = modes(fx)
    failures = 0
    try:
        # row 0: the kernel gate, every kernel == its plain version ON THE
        # CARD (CPU parity says nothing of what nvcc built)
        try:
            rc = kernel_check.main(["--reads", "60"]
                                   + (["--allow-cpu"] if args.allow_cpu else []))
        except Exception as e:  # noqa: BLE001 — report, keep smoking
            rc = 99
            print(f"kernel-check exception: {e}")
        failures += rc != 0
        print(f"[{'PASS' if rc == 0 else 'FAIL'}] kernel-parity-gate",
              flush=True)

        for name, argv_m in rows:
            if args.allow_cpu:
                argv_m = argv_m + ["--allow-cpu"]
            sink: list = []
            try:
                rc = cli_main(argv_m, echo=sink.append)
            except Exception as e:  # noqa: BLE001 — report, keep smoking
                rc, sink = 99, [f"exception: {e}"]
            failures += rc != 0
            tail = sink[-1] if sink else ""
            print(f"[{'PASS' if rc == 0 else 'FAIL'}] {name}"
                  + ("" if rc == 0 else f" (rc={rc}): {tail[-200:]}"),
                  flush=True)
    finally:
        os.chdir(cwd)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if args.keep or failures:
        print(f"fixtures: {tmp}")
    else:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"{len(rows) + 1 - failures}/{len(rows) + 1} checks passed")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
