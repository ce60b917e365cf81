"""Port parity: the window-stream mapper (PyTorch on the CPU) against the
JAX package's WindowStreamMapper, every CoarseResults field and stat equal,
on tests/test_window_stream.py's cases (parity, the key cap, 3N, budgets
equal to no budgets), --threeN --undirectional on four-strand reads, and
probe_tables' max_values_per_key against the JAX probe."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashreadmapper_tpu.config import ProgramOptions as JaxOptions
from hashreadmapper_tpu.cpu import oracle
from hashreadmapper_tpu.index import minhash_index as jax_mi
from hashreadmapper_tpu.io.genome import Genome as JaxGenome
from hashreadmapper_tpu.pipeline.window_stream import \
    WindowStreamMapper as JaxStream
from hashreadmapper_tpu_torch.config import ProgramOptions
from hashreadmapper_tpu_torch.index import minhash_index as mi
from hashreadmapper_tpu_torch.io.genome import Genome
from hashreadmapper_tpu_torch.pipeline.window_stream import WindowStreamMapper

from torch_helpers import ACGT, ensure_reference_native, four_strand_reads

FIELDS = ("orientation", "hamming", "shift", "chromosome_id", "position",
          "global_window_id", "bs_strand")


def _dataset(seed=33, n_reads=60, chrom_lens=(700, 420), maxlen=40):
    """tests/test_window_stream.py::_dataset."""
    rng = random.Random(seed)
    chroms = ["".join(rng.choice("ACGT") for _ in range(n))
              for n in chrom_lens]
    reads = []
    for _ in range(n_reads):
        rl = rng.randint(14, maxlen)
        if rng.random() < 0.8:
            c = rng.randrange(len(chroms))
            s = rng.randrange(len(chroms[c]) - rl)
            b = oracle.encode_bases(chroms[c][s:s + rl])
            if rng.random() < 0.5:
                b = oracle.revcomp_bases(b)
            if rng.random() < 0.3:
                b[rng.randrange(rl)] = rng.randrange(4)
        else:
            b = [rng.randrange(4) for _ in range(rl)]
        reads.append(b)
    bases = np.zeros((n_reads, maxlen), dtype=np.int8)
    lens = np.zeros(n_reads, dtype=np.int32)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = r
        lens[i] = len(r)
    return chroms, bases, lens


def _both(chroms, bases, lens, **kw):
    """(JAX results, port results) of the same reads, genome and options."""
    ensure_reference_native()
    names = [f"c{i}" for i in range(len(chroms))]
    ref = JaxStream(bases.copy(), lens.copy(), JaxOptions(**kw)).map_genome(
        JaxGenome(names, chroms))
    got = WindowStreamMapper(bases.copy(), lens.copy(), ProgramOptions(**kw),
                             "cpu").map_genome(Genome(names, chroms))
    return ref, got


def _assert_equal(ref, got):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(ref, f).dtype, f
    assert got.stats == ref.stats


BASE = dict(kmer_length=8, num_hash_functions=8, window_size=32,
            min_table_hits=2, batchsize=16, max_hamming_percent=0.15,
            probe_cap=128, candidates_per_read_cap=64, max_read_length=40,
            max_results_per_map=100000)


def test_parity_mode_equals_jax():
    chroms, bases, lens = _dataset()
    ref, got = _both(chroms, bases, lens, **BASE)
    assert int((got.orientation != 3).sum()) > 20
    _assert_equal(ref, got)


def test_key_cap_equals_jax():
    """Repetitive reads: max_results_per_map 4 drops over-full read keys
    (the drop-all rule at probe time)."""
    rng = random.Random(2)
    unit = "".join(rng.choice("ACGT") for _ in range(30))
    chroms = [unit * 8]
    n = 40
    bases = np.zeros((n, 24), dtype=np.int8)
    lens = np.full(n, 24, dtype=np.int32)
    for i in range(n):
        s = rng.randrange(len(chroms[0]) - 24)
        bases[i, :] = oracle.encode_bases(chroms[0][s:s + 24])
    opts = dict(kmer_length=8, num_hash_functions=8, window_size=32,
                min_table_hits=2, batchsize=16, max_hamming_percent=0.2,
                probe_cap=256, candidates_per_read_cap=128,
                max_read_length=24, max_results_per_map=4)
    ref, got = _both(chroms, bases, lens, **opts)
    _assert_equal(ref, got)
    # the cap bites: without it more reads map
    loose, _ = _both(chroms, bases, lens, **dict(opts,
                                                 max_results_per_map=10**5))
    assert (loose.orientation != 3).sum() > (got.orientation != 3).sum()


def test_three_n_equals_jax():
    rng = random.Random(91)
    chroms, bases, lens = _dataset(seed=91)
    for i in range(len(lens)):
        for j in range(lens[i]):
            if bases[i, j] == 1 and rng.random() < 0.85:
                bases[i, j] = 3
    opts = dict(BASE, max_hamming_percent=0.2, three_n_seeding=True)
    del opts["max_results_per_map"]
    ref, got = _both(chroms, bases, lens, **opts)
    assert int((got.orientation != 3).sum()) > len(lens) // 4
    _assert_equal(ref, got)


def test_budgets_equal_jax_and_no_budgets():
    """Pair compaction and the two-tier, head-compacted probe: equal to
    the JAX package, and to the run without budgets while their counters
    stay 0."""
    chroms, bases, lens = _dataset()
    budgets = dict(shd_pairs_per_read_budget=32,
                   probe_tail_budget_per_read=64,
                   probe_head_budget_per_read=64)
    ref, got = _both(chroms, bases, lens, **BASE, **budgets)
    _assert_equal(ref, got)
    for k in ("pair_budget_overflow", "probe_tail_overflow",
              "probe_head_overflow"):
        assert got.stats[k] == 0, k
    plain = WindowStreamMapper(bases.copy(), lens.copy(),
                               ProgramOptions(**BASE), "cpu").map_genome(
        Genome(["c0", "c1"], chroms))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(plain, f),
                                      err_msg=f)


def test_budgets_that_drop_equal_jax():
    """Budgets small enough to drop pairs and probes: the drop counters
    and the results as the JAX package's."""
    chroms, bases, lens = _dataset(seed=5, n_reads=80)
    opts = dict(BASE, shd_pairs_per_read_budget=1,
                probe_tail_budget_per_read=1, probe_head_budget_per_read=2)
    ref, got = _both(chroms, bases, lens, **opts)
    _assert_equal(ref, got)
    assert got.stats["pair_budget_overflow"] > 0


def test_undirectional_four_strand_equals_jax():
    """--threeN --undirectional on four-strand reads: the 4F read index,
    the mirrored SHD evaluation and the strand column."""
    rng = np.random.default_rng(17)
    chrom = rng.integers(0, 4, size=3000, dtype=np.int8)
    reads, lens, _, kind = four_strand_reads(rng, chrom, 12, read_len=60)
    chroms = ["".join(ACGT[chrom])]
    opts = dict(kmer_length=10, num_hash_functions=6, window_size=48,
                min_table_hits=2, batchsize=32, max_hamming_percent=0.1,
                probe_cap=64, candidates_per_read_cap=16, max_read_length=64,
                three_n_seeding=True, undirectional=True)
    ref, got = _both(chroms, reads, lens, **opts)
    _assert_equal(ref, got)
    mapped = got.orientation != 3
    assert mapped[kind >= 2].sum() > 12
    assert (got.bs_strand[kind >= 2] != 0).sum() > 6


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_max_values_per_key_equals_jax_probe(cap):
    """probe_tables with max_values_per_key (binary search, buckets and
    the plain searchsorted) against the JAX probe: candidates and
    counts; and the cuckoo probe refuses it."""
    rng = np.random.default_rng(cap)
    n_items, f, n_q = 60, 3, 40
    sigs = rng.integers(0, 30, size=(n_items, f)).astype(np.uint32)
    valid = rng.random(n_items) < 0.9
    q = rng.integers(0, 34, size=(n_q, f)).astype(np.uint32)
    q_valid = rng.random(n_q) < 0.9
    hash_ids = np.arange(f, dtype=np.uint32)
    jidx = jax_mi.build_csr_index_device(jnp.asarray(sigs),
                                         jnp.asarray(valid), 8, hash_ids)
    jidx.build_buckets()
    tidx = mi.build_csr_index_device(torch.from_numpy(sigs.astype(np.int64)),
                                     torch.from_numpy(valid), 8, hash_ids)
    tidx.build_buckets()
    for buckets in (True, False):
        ref = jax_mi.probe_tables(
            jidx.keys, jidx.offsets, jidx.values, jidx.num_keys,
            jnp.asarray(q), jnp.asarray(q_valid), 8,
            bucket_start=jidx.bucket_start if buckets else None,
            probe_steps=jidx.probe_steps, max_values_per_key=cap,
            fnc_layout=True)
        got = mi.probe_tables(
            tidx.keys, tidx.offsets, tidx.values, tidx.num_keys,
            torch.from_numpy(q.astype(np.int64)), torch.from_numpy(q_valid),
            8, bucket_start=tidx.bucket_start if buckets else None,
            probe_steps=tidx.probe_steps, max_values_per_key=cap)
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.asarray(ref[0]).astype(np.int64))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        counts = got[1].numpy()
        assert (counts <= cap).all() and (counts > 0).any()
    with pytest.raises(ValueError, match="max_values_per_key"):
        mi.probe_tables(
            tidx.keys, tidx.offsets, tidx.values, tidx.num_keys,
            torch.from_numpy(q.astype(np.int64)), torch.from_numpy(q_valid),
            8, cuckoo=(tidx.keys, tidx.offsets), cuckoo_bits=4,
            max_values_per_key=cap)
