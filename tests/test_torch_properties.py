"""Property tests of the port against the JAX package on generated inputs
(the port's counterpart of test_hypothesis.py and test_properties.py):
the packed round trip, the scorers against the golden DPs, Kadane parity,
CIGARs, k-mer counts and the drain codec's round trip. IUPAC codes and
lowercase bytes are among the generated reads. Same hypothesis profiles
as test_hypothesis.py: ``ci`` (25 examples) unless MPT_HYPOTHESIS_PROFILE
names another."""

from __future__ import annotations

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from mini_parallel_tpu.ops import encode as jencode
from mini_parallel_tpu.ops import kadane as jkadane
from mini_parallel_tpu.ops import kmer as jkmer
from mini_parallel_tpu.ops import packed as jpacked
from mini_parallel_tpu.ops import sw as jsw
from mini_parallel_tpu.ops import sw_traceback as jtb
from mini_parallel_tpu_torch.native import kmer_store
from mini_parallel_tpu_torch.ops import encode, kadane, kmer, packed, sw
from mini_parallel_tpu_torch.ops import sw_traceback as tb

settings.register_profile("ci", max_examples=25, deadline=None)
settings.register_profile("deep", max_examples=200, deadline=None)
settings.load_profile(os.environ.get("MPT_HYPOTHESIS_PROFILE", "ci"))

CPU = torch.device("cpu")
PAD = 48
dna = st.text(alphabet="ACGT", min_size=0, max_size=PAD)
messy = st.text(alphabet="ACGTNacgtnRYKM", min_size=0, max_size=PAD)


def _pair(a: bytes, b: bytes):
    """(a, b) padded to PAD as uint8 arrays, with their lengths."""
    arr_a, la = encode.pad_batch([a], pad_to=PAD, pad_value=int(encode.PAD_A))
    arr_b, lb = encode.pad_batch([b], pad_to=PAD, pad_value=int(encode.PAD_B))
    return arr_a, arr_b, la, lb


@given(st.lists(messy, min_size=1, max_size=12))
def test_packed_roundtrip_matches_jax(seqs):
    reads = [s.encode() for s in seqs]
    pad = -(-max(max(len(r) for r in reads), 4) // 4) * 4
    arr, lens = encode.pad_batch(reads, pad_to=pad,
                                 pad_value=int(encode.PAD_A))
    pb = packed.pack_batch(arr, lens)
    jpb = jpacked.pack_batch(arr, lens)
    for field in ("packed", "exc_col", "exc_val", "lengths"):
        assert np.array_equal(getattr(pb, field), getattr(jpb, field))
    out = packed.unpack_device(*packed.device_args(pb, CPU),
                               int(encode.PAD_A))
    assert np.array_equal(out.numpy(), arr)


@given(messy, messy)
def test_scorers_match_jax_and_the_golden_dps(a, b):
    a, b = a.encode(), b.encode()
    arr_a, arr_b, _, _ = _pair(a, b)
    ta, tb_ = torch.from_numpy(arr_a), torch.from_numpy(arr_b)
    ja, jb = jnp.asarray(arr_a), jnp.asarray(arr_b)
    lin = int(sw.sw_score_batch(ta, tb_)[0])
    assert lin == int(jsw.sw_score_batch(ja, jb)[0]) == sw.sw_score_numpy(a, b)
    aff = int(sw.sw_affine_batch(ta, tb_)[0])
    assert aff == int(jsw.sw_affine_batch(ja, jb)[0]) == \
        sw.sw_affine_numpy(a, b)


@given(messy, messy)
def test_kadane_parity_matches_jax_and_the_emulation(a, b):
    a, b = a.encode(), b.encode()
    arr_a, arr_b, la, lb = _pair(a, b)
    got = int(kadane.kadane_score_batch(
        torch.from_numpy(arr_a), torch.from_numpy(arr_b),
        torch.from_numpy(la), torch.from_numpy(lb))[0])
    want = int(jkadane.kadane_score_batch(
        jnp.asarray(arr_a), jnp.asarray(arr_b), jnp.asarray(la),
        jnp.asarray(lb))[0])
    assert got == want == kadane.reference_align_score(a, b)


@given(st.lists(st.tuples(messy, messy), min_size=1, max_size=6),
       st.sampled_from([(-5, -1), (-3, 0), (-6, -2)]))
def test_cigars_match_jax(pairs, gaps):
    ra = [a.encode() for a, _ in pairs]
    rb = [b.encode() for _, b in pairs]
    arr_a, _ = encode.pad_batch(ra, pad_to=PAD, pad_value=int(encode.PAD_A))
    arr_b, _ = encode.pad_batch(rb, pad_to=PAD, pad_value=int(encode.PAD_B))
    ta, tb_ = torch.from_numpy(arr_a), torch.from_numpy(arr_b)
    ja, jb = jnp.asarray(arr_a), jnp.asarray(arr_b)
    fields = lambda alns: [dataclasses.astuple(x) for x in alns]  # noqa: E731
    assert fields(tb.sw_align_batch(ta, tb_)) == \
        fields(jtb.sw_align_batch(ja, jb))
    assert fields(tb.sw_affine_align_batch(ta, tb_, *gaps)) == \
        fields(jtb.sw_affine_align_batch(ja, jb, *gaps))


@given(st.lists(messy, min_size=1, max_size=8), st.integers(3, 8),
       st.booleans())
def test_kmer_counts_match_jax_and_the_golden(seqs, k, canonical):
    reads = [s.encode() for s in seqs]
    pad = -(-max(max(len(r) for r in reads), k + 1) // 8) * 8
    arr, lens = encode.pad_batch(reads, pad_to=pad,
                                 pad_value=int(encode.PAD_A))
    keys, counts, n = kmer.unique_counts_batch(
        encode.ascii_to_code(torch.from_numpy(arr)), torch.from_numpy(lens),
        k=k, canonical=canonical)
    hi, lo, ct, nu = jkmer.unique_counts_batch(
        jencode.ascii_to_code(jnp.asarray(arr)), jnp.asarray(lens), k=k,
        canonical=canonical)
    nu = int(nu)
    assert n == nu
    assert np.array_equal(keys.numpy(), kmer.join_keys(
        np.asarray(hi)[:nu], np.asarray(lo)[:nu], k))
    assert np.array_equal(counts.numpy(), np.asarray(ct)[:nu])
    golden = kmer.count_kmers_python(reads, k, canonical)
    assert {kmer.key_to_string(key, k): c for key, c in
            zip(keys.tolist(), counts.tolist())} == dict(golden)


@given(st.lists(st.integers(0, (1 << 60) - 1), min_size=1, max_size=300,
                unique=True),
       st.integers(1, 1 << 20), st.integers(5, 30), st.booleans())
def test_plane_codec_round_trip_and_jax_bytes(raw_keys, max_count, k, order):
    """Keys of k bases, ascending (the store) or as generated: both
    decoders give them back; ascending, the planes are the JAX package's
    _plane_pack bytes."""
    keys = np.array(raw_keys, np.int64) >> (60 - 2 * k)
    keys = np.unique(keys) if order else keys
    counts = (np.arange(keys.size, dtype=np.int64) * 7919) % max_count + 1
    planes, kp, cp, key0 = kmer.plane_pack(torch.from_numpy(keys),
                                           torch.from_numpy(counts))
    m = keys.size
    for got in (kmer_store.decode_planes_native(planes.numpy(), m, kp, cp,
                                                key0),
                kmer.decode_planes_numpy(planes.numpy(), m, kp, cp, key0)):
        assert np.array_equal(got[0], keys) and np.array_equal(got[1], counts)
    if order:
        hi, lo = kmer.split_keys(keys, k)
        jplanes = jkmer._plane_pack(
            jnp.asarray(hi), jnp.asarray(lo),
            jnp.asarray(counts.astype(np.int32)), kp, cp, s=kmer.lo_bits(k))
        assert np.array_equal(planes.numpy().reshape(-1), np.asarray(jplanes))
