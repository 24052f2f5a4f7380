"""The PyTorch port's host modules and tensor ops vs the JAX package's, on
the same seeded numpy inputs. Every comparison is exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_parallel_tpu.io import fastq as jfastq
from mini_parallel_tpu.ops import encode as jencode
from mini_parallel_tpu.ops import kadane as jkadane
from mini_parallel_tpu.ops import packed as jpacked
from mini_parallel_tpu.utils import checkpoint as jcheckpoint
from mini_parallel_tpu.utils import config as jconfig
from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.ops import encode, kadane, packed
from mini_parallel_tpu_torch.utils import checkpoint, config
from tests.conftest import random_dna

CPU = torch.device("cpu")


def _rows(rng, B, lo, hi, alphabet=b"ACGT"):
    return [random_dna(rng, int(rng.integers(lo, hi + 1)), alphabet)
            for _ in range(B)]


def _flat(rows):
    flat = np.frombuffer(b"".join(rows), np.uint8)
    offs = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    return flat, offs


@pytest.mark.parametrize("lo,hi,rows_to", [
    (40, 40, None),    # uniform: the reshape path
    (1, 60, None),     # ragged: the scatter path
    (10, 30, 48),      # rows padded up with empty rows
    (0, 0, 8),         # an all-empty chunk
])
def test_pad_batch_flat_matches_jax(rng, lo, hi, rows_to):
    flat, offs = _flat(_rows(rng, 23, lo, hi))
    for pad_value in (int(encode.PAD_A), int(encode.PAD_B)):
        got = encode.pad_batch_flat(flat, offs, pad_to=64, pad_value=pad_value,
                                    rows_to=rows_to)
        want = jencode.pad_batch_flat(flat, offs, pad_to=64,
                                      pad_value=pad_value, rows_to=rows_to)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


def test_pad_batch_matches_jax(rng):
    rows = _rows(rng, 17, 0, 50, alphabet=b"ACGTN")
    got = encode.pad_batch(rows, pad_to=56, pad_value=int(encode.PAD_B))
    want = jencode.pad_batch(rows, pad_to=56, pad_value=int(jencode.PAD_B))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert (encode.PAD_A, encode.PAD_B) == (jencode.PAD_A, jencode.PAD_B)


@pytest.mark.parametrize("alphabet", [b"ACGT", b"ACGTN", b"ACGTNacgtRY"])
def test_pack_unpack_matches_jax(rng, alphabet):
    rows = _rows(rng, 31, 0, 64, alphabet=alphabet)
    arr, lens = encode.pad_batch(rows, pad_to=64, pad_value=int(encode.PAD_A))
    pb = packed.pack_batch(arr, lens)
    jpb = jpacked.pack_batch(arr, lens)
    for f in ("packed", "exc_col", "exc_val", "lengths"):
        assert np.array_equal(getattr(pb, f), getattr(jpb, f)), f
    pb, jpb = packed.pad_rows(pb, 40), jpacked.pad_rows(jpb, 40)
    for pad_value in (int(encode.PAD_A), int(encode.PAD_B)):
        got = packed.unpack_device(*packed.device_args(pb, CPU), pad_value)
        want = jpacked.unpack_device(*jpacked.device_args(jpb), pad_value)
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), np.asarray(want))
        expect = np.full((40, 64), pad_value, np.uint8)
        for i, r in enumerate(rows):
            expect[i, :len(r)] = np.frombuffer(r, np.uint8)
        assert np.array_equal(got.numpy(), expect)


def test_pack_rejects_unaligned_width():
    with pytest.raises(ValueError):
        packed.pack_batch(np.zeros((2, 6), np.uint8), np.zeros(2, np.int32))


@pytest.mark.parametrize("alphabet", [b"ACGT", b"AC", b"A"])
def test_kadane_score_batch_matches_jax_and_reference(rng, alphabet):
    ra = _rows(rng, 29, 0, 40, alphabet=alphabet)
    rb = _rows(rng, 29, 0, 40, alphabet=alphabet)
    a, la = encode.pad_batch(ra, pad_to=48, pad_value=int(encode.PAD_A))
    b, lb = encode.pad_batch(rb, pad_to=48, pad_value=int(encode.PAD_B))
    got = kadane.kadane_score_batch(*(torch.from_numpy(x) for x in (a, b, la, lb)))
    want = jkadane.kadane_score_batch(*(jnp.asarray(x) for x in (a, b, la, lb)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [kadane.reference_align_score(x, y)
                            for x, y in zip(ra, rb)]


def test_reference_align_score_matches_jax_strided(rng):
    """The general strided regime (tiny work groups), not just the
    degenerate one."""
    for _ in range(20):
        x = random_dna(rng, int(rng.integers(0, 70)), b"ACG")
        y = random_dna(rng, int(rng.integers(0, 70)), b"ACG")
        for wgs, groups in ((4, 2), (3, 5), (1024, 1_000_000)):
            assert kadane.reference_align_score(x, y, wgs, groups) == \
                jkadane.reference_align_score(x, y, wgs, groups)
            n = min(len(x), len(y))
            assert kadane.degenerate_regime(n, wgs, groups) == \
                jkadane.degenerate_regime(n, wgs, groups)


def test_config_matches_jax(tmp_path):
    env_file = tmp_path / "x.env"
    env_file.write_text("# c\nWGS_DATA_DIR=/d\nWGS_LANES=3\n"
                        "GPU_CHUNK_SIZE_READS='77'\nMPT_MESH_SHAPE=4x2\n"
                        "MPT_PACKED_TRANSFER=false\nWGS_READS_PER_LANE=x\n")
    env, jenv = {}, {}
    config.load_dotenv(str(env_file), env)
    jconfig.load_dotenv(str(env_file), jenv)
    assert env == jenv
    got, want = config.get_config(env), jconfig.get_config(jenv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.wgs_file_list() == want.wgs_file_list()
    default = config.get_config({}, require_chunk_size=False)
    assert (default.read_pad, default.packed_transfer) == (152, True)
    with pytest.raises(config.ConfigError):
        config.get_config({})


def test_checkpoint_round_trips_with_jax(tmp_path):
    files = ["/d/S_L001_R1_001.fastq.gz", "/d/S_L001_R2_001.fastq.gz"]
    for mode in ("kadane", "sw"):
        assert checkpoint.deterministic_run_id("S", files, mode, 10) == \
            jcheckpoint.deterministic_run_id("S", files, mode, 10)
    st = checkpoint.CheckpointState(run_id="r", total_files=2,
                                    directory=str(tmp_path))
    st.add_file_result(checkpoint.FileCheckpoint(
        file_path=files[0], file_index=0, score=4, processing_time_ms=1.5,
        total_bases=30, total_reads=3, completed=False, chunks_done=1))
    back = jcheckpoint.CheckpointState.load("r", str(tmp_path))
    assert dataclasses.asdict(back.files[0]) == dataclasses.asdict(st.files[0])
    assert back.totals() == st.totals()


def test_iter_flat_chunks_matches_jax(tmp_path, rng):
    rows = _rows(rng, 23, 1, 90, alphabet=b"ACGTN")
    path = str(tmp_path / "r.fastq.gz")
    fastq.write_fastq(path, rows)
    got = list(fastq.iter_flat_chunks(path, 5))
    want = list(jfastq.iter_flat_chunks(path, 5, engine="python"))
    assert len(got) == len(want) == 5
    for (f, o), (jf, jo) in zip(got, want):
        assert np.array_equal(f, jf) and np.array_equal(o, jo)
    assert fastq.count_bases(path, 5) == sum(map(len, rows))
    assert [len(c) for c in fastq.iter_read_chunks(path, 5)] == [5, 5, 5, 5, 3]


def test_prefetch_stops_producer_on_close():
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    with fastq.prefetch(gen(), depth=2) as it:
        assert next(it) == 0
        thread = it._thread
    assert not thread.is_alive()  # joined on exit, not left to GC
    assert len(produced) < 10


def test_prefetch_reraises_and_ends():
    def bad():
        yield 1
        raise OSError("boom")

    with fastq.prefetch(bad()) as it:
        assert next(it) == 1
        with pytest.raises(OSError, match="boom"):
            next(it)
    with fastq.prefetch(iter([1, 2])) as it:
        assert list(it) == [1, 2]
        assert list(it) == []  # an ended prefetch stays ended
    assert not it._thread.is_alive()
